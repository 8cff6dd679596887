"""Megatron tensor parallelism of the Conformer blocks (``parallel/tensor.py``)
on 4 gloo ranks against one process and against the JAX package's tensor
parallelism (JAX tests/test_sharding_consistency.py::test_tp_mesh_agrees
holds the JAX rules against one device).

The weights come from the JAX Conformer's (``conformer_to_torch``). One
spawn of 4 ranks (tests/torch_dist_workers.py ``scenario_tp``):

- a tiny Conformer (4 heads) split over 2 model ranks (x data 2) and over
  4, with dropout 0.1 from one generator: the output (atol 2e-5) and every
  parameter's gradient, gathered whole, against the unsplit model (atol
  2e-6, rtol 1e-4); each rank holds 1/n_model of the split tensors; the
  ``return_attn`` maps gathered over the heads equal the unsplit model's
  (atol 1e-6);
- the same without dropout against the JAX Conformer run under
  ``param_shardings`` on a model-2 and a model-4 mesh of the virtual CPU
  devices: the output at valid positions (atol/rtol 1e-4, the port's
  Conformer-vs-JAX tolerance) and the whole gradients (``GRAD_TOL`` of
  tests/test_torch_s2a_train.py);
- one s2a ``Trainer`` step on fsdp 2 x model 2 against one process with 2
  micro-batches: the loss (relative 1e-5) and the parameters
  (``PARAM_TOL``); its checkpoint holds whole tensors that equal the
  one-process model, with whole AdamW moments.

``to_kv`` and the conv module's ``pw_in`` are split half by half; the
weights here are random, so their halves differ and a plain column split
would pair rank 0's k with rank 1's v (``test_halves_split_separately``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.conformer import Conformer as JConformer
from edm_tts_tpu.models.conformer import ConformerConfig as JConformerConfig
from edm_tts_tpu.models.conformer.convert import conformer_to_torch
from edm_tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from edm_tts_tpu.parallel.mesh import param_shardings
from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models.conformer.conformer import Conformer, ConformerConfig
from edm_tts_tpu_torch.parallel.tensor import BLOCK_RULES, shard_tensor, unshard_tensor
from edm_tts_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_s2a_train import GRAD_TOL, PARAM_TOL
from torch_dist_workers import s2a_trainer, spawn
from torch_port_parity import random_variables, s2a_pair

SHAPE = dict(dim=32, depth=2, dim_head=8, heads=4, conv_kernel_size=7)
CFG = ConformerConfig(**SHAPE, ff_dropout=0.1, conv_dropout=0.1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _to_torch(tree) -> dict[str, np.ndarray]:
    sd: dict = {}
    conformer_to_torch(sd, tree, "c", SHAPE["depth"])
    return {k[len("c."):]: np.asarray(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX Conformer's variables, and its output and gradients under
    ``param_shardings`` on a (model n) mesh for n = 2 and 4."""
    jmodel = JConformer(JConformerConfig(**SHAPE))
    variables = random_variables(lambda r: jmodel.init(r, jnp.zeros((1, 8, SHAPE["dim"]))),
                                 seed=3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, SHAPE["dim"])).astype(np.float32)
    mask = np.arange(20)[None, :] < np.array([20, 13])[:, None]

    def loss(v, x, m):
        y = jmodel.apply(v, x, mask=m, conv_pad_mask=m)
        return (jnp.square(y) * m[..., None]).mean(), y

    runs = {}
    for n in (2, 4):
        mesh = j_make_mesh(1, 1, n, devices=jax.devices()[:n])
        shardings = param_shardings(mesh, variables, min_size=2 ** 8)
        specs = [s.spec for s in jax.tree_util.tree_leaves(shardings)]
        assert any("model" in jax.tree_util.tree_leaves(tuple(s)) for s in specs)
        (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.device_put(variables, shardings), jnp.asarray(x), jnp.asarray(mask))
        runs[n] = np.asarray(y), _to_torch(grads["params"])
    return dict(state=_to_torch(variables["params"]), x=x, mask=mask, runs=runs)


@pytest.fixture(scope="module")
def run(tmp_path_factory, jax_side):
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(2)
    conformer = Conformer(CFG)
    load_reference_state_dict(conformer, jax_side["state"])
    x, mask = jax_side["x"], jax_side["mask"]
    s2a = s2a_pair(seed=3)[2]
    s2a_batch = {"acoustic_tokens": rng.integers(0, 16, (4, 4, 12)).astype(np.int32),
                 "semantic_tokens": rng.integers(0, 8, (4, 12)).astype(np.int32)}
    torch.save(dict(conformer=conformer, x=x, mask=mask, s2a=s2a, s2a_batch=s2a_batch),
               tmp / "inputs.pt")
    results = spawn("tp", 4, tmp)
    y_ref = conformer(torch.as_tensor(x), mask=torch.as_tensor(mask),
                      conv_pad_mask=torch.as_tensor(mask),
                      dropout_generator=torch.Generator().manual_seed(5))
    (y_ref.square() * torch.as_tensor(mask)[..., None]).mean().backward()
    with torch.no_grad():
        attn_ref = conformer(torch.as_tensor(x), mask=torch.as_tensor(mask),
                             conv_pad_mask=torch.as_tensor(mask), return_attn=True)
    trainer = s2a_trainer(copy.deepcopy(s2a), tmp / "one", steps=1, batch=4, micro_batches=2)
    metrics = trainer.train_step(s2a_batch, 0)
    return dict(results=results, conformer=conformer, y=y_ref.detach(), tmp=tmp,
                one=(metrics, trainer.model.state_dict()), attn=attn_ref)


@pytest.mark.parametrize("n_model", [2, 4])
def test_split_conformer_matches_one_process(run, n_model):
    for r in run["results"]:
        np.testing.assert_allclose(r[f"y{n_model}"].numpy(), run["y"].numpy(), atol=2e-5)
        for n, p in run["conformer"].named_parameters():
            np.testing.assert_allclose(r[f"grads{n_model}"][n].numpy(), p.grad.numpy(),
                                       atol=2e-6, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("n_model", [2, 4])
def test_split_conformer_matches_jax_tensor_parallel(run, jax_side, n_model):
    y_ref, grads_ref = jax_side["runs"][n_model]
    mask = jax_side["mask"]
    for r in run["results"]:
        np.testing.assert_allclose(r[f"y{n_model}_nodrop"].numpy()[mask], y_ref[mask], **TOL)
        grads = r[f"grads{n_model}_nodrop"]
        assert grads.keys() == grads_ref.keys()
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), grads_ref[n], err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("n_model", [2, 4])
def test_attention_maps_are_gathered_over_the_heads(run, n_model):
    y_ref, maps_ref = run["attn"]
    for r in run["results"]:
        y, maps = r[f"attn{n_model}"]
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=2e-5)
        assert len(maps) == len(maps_ref)
        for a, b in zip(maps, maps_ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("n_model", [2, 4])
def test_each_rank_holds_its_part_of_the_split_tensors(run, n_model):
    full = {n: tuple(p.shape) for n, p in run["conformer"].named_parameters()}
    local = run["results"][0][f"local{n_model}"]
    assert local.keys() == full.keys()
    split = 0
    for n, shape in full.items():
        rule = BLOCK_RULES.get(n.split(".", 2)[2])
        if rule is None:
            assert local[n] == shape, n
        else:
            split += 1
            expect = list(shape)
            expect[rule[0]] //= n_model
            assert local[n] == tuple(expect), n
    assert split == len(BLOCK_RULES) * CFG.depth


def test_fsdp2_x_model2_step_matches_one_process(run):
    metrics, state = run["one"]
    for r in run["results"]:
        assert r["step"]["loss"].item() == pytest.approx(metrics["loss"].item(), rel=1e-5)
        assert r["step"]["grad_norm"].item() == pytest.approx(metrics["grad_norm"].item(),
                                                              rel=1e-5)
        for n, p in state.items():
            np.testing.assert_allclose(r["step_params"][n].numpy(), p.numpy(), err_msg=n,
                                       **PARAM_TOL)


def test_tensor_parallel_checkpoint_holds_whole_tensors(run):
    _, state = run["one"]
    saved, meta = CheckpointManager(str(run["tmp"] / "s2a_tp"), None).restore(1)
    assert meta == {"step": 1} and saved["optimizer"]["count"] == 1
    assert saved["model"].keys() == state.keys()
    for n, p in state.items():
        np.testing.assert_allclose(saved["model"][n].numpy(), p.numpy(), err_msg=n, **PARAM_TOL)
    for n, p in saved["optimizer"]["mu"].items():
        assert p.shape == state[n].shape, n


def test_halves_split_separately():
    w = torch.arange(8.0)[:, None].repeat(1, 3)  # rows 0-3 k, 4-7 v
    k0 = shard_tensor(w, 0, 2, 0, 2)
    assert k0[:, 0].tolist() == [0.0, 1.0, 4.0, 5.0]  # rank 0: k rows 0-1 and v rows 4-5
    assert not torch.equal(k0, w.chunk(2, 0)[0])  # a plain column split gives k only
    parts = [shard_tensor(w, 0, 2, i, 2) for i in range(2)]
    assert torch.equal(unshard_tensor(parts, 0, 2), w)
