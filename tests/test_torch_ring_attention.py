"""Ring attention (``ops/ring_attention.py``, ``mha(implementation="ring")``)
on 4 gloo ranks against JAX ``ring_mha`` and the plain attention.

One spawn of 4 ranks (tests/torch_dist_workers.py ``scenario_ring``):

- the ring of 4 on f32 q, k, v (B2 T32 H3 D8): the forward against JAX
  ``ring_mha`` on a ring of 4 virtual devices and against ``mha_reference``
  (atol/rtol 1e-5); with a mask that has a fully masked row (uniform
  attention over every key, as JAX's ring); the q/k/v gradients of
  sum(mean(out ** 2)) against JAX's (atol 1e-5, rtol 1e-4);
- rings of 2 (data 2 x sequence 2) in bf16 within 3e-2 of the f32 plain
  attention;
- a tiny Conformer built with ``attn_implementation="ring"`` under
  ``with mesh:`` (T 62: padded to the ring with keys that never count)
  against the same weights without the ring: the output (atol 2e-5) and
  every parameter's gradient (atol 2e-6, rtol 1e-4);
- one s2a ``Trainer`` step with n_seq 2 x data 2 against one process with
  2 micro-batches (JAX tests/test_seq_parallel_*.py);
- the ring's steps on one device (``chunked_mha``, what chip_smoke.py
  holds against whole-sequence K3/K4 on the card) against the plain
  attention, ragged, with chunks that hold no key for a row that has keys
  elsewhere, and with a fully masked row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.ops.attention import mha_reference as j_mha_reference
from edm_tts_tpu.ops.ring_attention import make_seq_mesh, ring_mha as j_ring_mha
from edm_tts_tpu_torch.models.conformer.conformer import Conformer, ConformerConfig
from edm_tts_tpu_torch.models.s2a import InjectionConformer
from edm_tts_tpu_torch.ops.attention import mha_reference
from edm_tts_tpu_torch.ops.ring_attention import chunked_mha, chunked_mha_bwd
from test_torch_s2a_train import PARAM_TOL
from torch_dist_workers import s2a_trainer, spawn, trainable
from torch_port_parity import s2a_pair

B, T, H, D = 2, 32, 3, 8
CFG = ConformerConfig(dim=32, depth=2, dim_head=16, heads=2, conv_kernel_size=7)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    qkv = [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3)]
    mask = rng.random((B, T)) < 0.8
    dead = rng.random((B, T)) < 0.7
    dead[1] = False  # a fully masked row
    torch.manual_seed(0)
    conformer = Conformer(CFG)
    ring_conformer = Conformer(dataclasses.replace(CFG, attn_implementation="ring"))
    ring_conformer.load_state_dict(conformer.state_dict())
    x = rng.standard_normal((4, 62, CFG.dim)).astype(np.float32)
    cmask = np.arange(62)[None, :] < np.array([62, 48, 33, 17])[:, None]
    s2a = s2a_pair(seed=3)[2]
    ring_s2a = InjectionConformer(dataclasses.replace(s2a.cfg, attn_implementation="ring"))
    ring_s2a.load_state_dict(s2a.state_dict())
    ring_s2a.acoustic_model.pack()
    s2a_batch = {"acoustic_tokens": rng.integers(0, 16, (4, 4, 12)).astype(np.int32),
                 "semantic_tokens": rng.integers(0, 8, (4, 12)).astype(np.int32)}
    inputs = dict(qkv=qkv, mask=mask, mask_dead_row=dead, ring_conformer=ring_conformer, x=x,
                  conformer_mask=cmask, ring_s2a=ring_s2a, s2a_batch=s2a_batch)
    torch.save(inputs, tmp / "inputs.pt")
    results = spawn("ring", 4, tmp)
    return results, inputs, conformer, s2a, tmp


def _joined(results, key):
    return torch.cat([r[key] for r in results], dim=1).float().numpy()


def _jax_ring(qkv, mask=None):
    mesh = make_seq_mesh(4, devices=jax.devices()[:4])
    q, k, v = (jnp.asarray(x) for x in qkv)
    if mask is None:
        return np.asarray(jax.jit(lambda q, k, v: j_ring_mha(q, k, v, mesh=mesh))(q, k, v))
    return np.asarray(jax.jit(lambda q, k, v, m: j_ring_mha(q, k, v, mesh=mesh, mask=m))(
        q, k, v, jnp.asarray(mask)))


def test_ring_forward_matches_jax_ring_and_the_plain_attention(run):
    results, inputs, *_ = run
    out = _joined(results, "plain")
    np.testing.assert_allclose(out, _jax_ring(inputs["qkv"]), **TOL)
    q, k, v = (torch.as_tensor(x) for x in inputs["qkv"])
    np.testing.assert_allclose(out, mha_reference(q, k, v).numpy(), **TOL)


def test_ring_with_a_fully_masked_row(run):
    results, inputs, *_ = run
    out = _joined(results, "masked")
    np.testing.assert_allclose(out, _jax_ring(inputs["qkv"], inputs["mask_dead_row"]), **TOL)
    v = inputs["qkv"][2]
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), out[1].shape), **TOL)


def test_ring_gradients_match_jax(run):
    results, inputs, *_ = run
    mesh = make_seq_mesh(4, devices=jax.devices()[:4])
    mask = jnp.asarray(inputs["mask"])

    def loss(q, k, v):
        return jnp.mean(jnp.square(j_ring_mha(q, k, v, mesh=mesh, mask=mask)))

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in inputs["qkv"]))
    for i, name in enumerate("qkv"):
        got = torch.cat([r["grads"][i] for r in results], dim=1).numpy()
        np.testing.assert_allclose(got, np.asarray(ref[i]), atol=1e-5, rtol=1e-4, err_msg=name)
    dense = jax.jit(jax.grad(lambda q, k, v: jnp.mean(jnp.square(
        j_mha_reference(q, k, v, mask=mask))), argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in inputs["qkv"]))
    for i, name in enumerate("qkv"):
        got = torch.cat([r["grads"][i] for r in results], dim=1).numpy()
        np.testing.assert_allclose(got, np.asarray(dense[i]), atol=1e-5, rtol=1e-4, err_msg=name)


def test_ring_bf16_on_rings_of_two(run):
    results, inputs, *_ = run
    q, k, v = (torch.as_tensor(x) for x in inputs["qkv"])
    ref = mha_reference(q, k, v).numpy()
    for pair in (results[:2], results[2:]):
        assert all(r["bf16"].dtype == torch.bfloat16 for r in pair)
        np.testing.assert_allclose(_joined(pair, "bf16"), ref, atol=3e-2, rtol=3e-2)


def test_ring_conformer_matches_the_unsharded_one(run):
    results, inputs, conformer, *_ = run
    x, mask = torch.as_tensor(inputs["x"]), torch.as_tensor(inputs["conformer_mask"])
    y = conformer(x, mask=mask, conv_pad_mask=mask)
    (y.square() * mask[..., None]).mean().backward()
    for r in results:
        np.testing.assert_allclose(r["conformer"].numpy(), y.detach().numpy(), atol=2e-5)
        for n, p in conformer.named_parameters():
            np.testing.assert_allclose(r["conformer_grads"][n].numpy(), p.grad.numpy(),
                                       atol=2e-6, rtol=1e-4, err_msg=n)


def test_trainer_step_with_n_seq_2_matches_one_process(run):
    results, inputs, _, s2a, tmp = run
    trainer = s2a_trainer(s2a, tmp / "one", steps=1, batch=4, micro_batches=2)
    metrics = trainer.train_step(inputs["s2a_batch"], 0)
    params = trainable(trainer.model)
    for r in results:
        assert r["step"]["loss"].item() == pytest.approx(metrics["loss"].item(), rel=1e-5)
        for n, p in params.items():
            np.testing.assert_allclose(r["step_params"][n].numpy(), p.numpy(), err_msg=n,
                                       **PARAM_TOL)


@pytest.mark.parametrize("t,n", [(32, 2), (29, 4)])
def test_ring_steps_on_one_device_match_the_plain_attention(t, n):
    rng = np.random.default_rng(t)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, t, H, D)).astype(np.float32))
               for _ in range(3))
    mask = torch.as_tensor(rng.random((B, t)) < 0.7)
    mask[0, t // 2:] = False  # row 0's later chunks hold no key: they must weigh 0
    mask[1] = False
    o, lse = chunked_mha(q, k, v, mask, n)
    np.testing.assert_allclose(o.numpy(), mha_reference(q, k, v, mask=mask).numpy(), **TOL)
    g = torch.as_tensor(rng.standard_normal(o.shape).astype(np.float32))
    grads = chunked_mha_bwd(q, k, v, mask, o, lse, g, n)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    mha_reference(*leaves, mask=mask).backward(g)
    for got, leaf, name in zip(grads, leaves, "qkv"):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
