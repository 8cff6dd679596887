"""The port's s2a training against the JAX package's, on the CPU in f32.

Same weights on both sides (``s2a_pair``: tiny s2a, tiny codec, dropout 0)
and the same mask (``mask_override``: torch cannot reproduce
``jax.random``). Tolerances: the loss to a relative 1e-5; each trainable
gradient atol 2e-6 + rtol 1e-4 (f32, another summation order through 4
blocks, the heads and the cross-entropy; the largest entries are ~1e-1);
parameters after optimizer steps atol/rtol 1e-6 (the same update
arithmetic as optax in f32). The JAX gradient tree goes through the
package's own ``to_torch_state_dict`` (the codec subtree replaced by its
parameters, whose gradient is zero) to reference names; the frozen codec
(``acoustic_model.*``) is left out and must keep its weights.
"""

import itertools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edm_tts_tpu.models.s2a.convert import to_torch_state_dict as s2a_to_torch
from edm_tts_tpu.train.optim import adamw as j_adamw
from edm_tts_tpu.train.optim import freeze_subtree_mask
from edm_tts_tpu.train.optim import warmup_cosine_schedule as j_schedule
from edm_tts_tpu_torch.train.export import load_s2a, save_pretrained, save_s2a
from edm_tts_tpu_torch.train.optim import AdamW, freeze_submodule, warmup_cosine_schedule
from edm_tts_tpu_torch.train.run_s2a import build_model
from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments
from torch_port_parity import TINY_S2A, s2a_pair

B, Q, T, N, V = 4, 4, 12, 16, 8
LR, WARMUP, TOTAL, CLIP = 1e-2, 2, 10, 0.05
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)
PARAM_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def setup():
    """Models, a batch, a mask and both sides' loss and gradients."""
    jmodel, variables, model = s2a_pair(seed=3)
    freeze_submodule(model, "acoustic_model")
    rng = np.random.default_rng(5)
    ac = rng.integers(0, N, (B, Q, T)).astype(np.int32)
    sem = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = rng.random((B, T)) < 0.5
    mask[:, 0] = True  # every row has masked positions

    def jloss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(ac), jnp.asarray(sem),
                           mask_rng=jax.random.PRNGKey(0), mask_override=jnp.asarray(mask),
                           train=True)
        return out["loss"]

    jl, jgrads = jax.value_and_grad(jloss)(variables["params"])
    jgrads = {**jgrads, "codec": variables["params"]["codec"]}
    ref_grads = {k: v for k, v in s2a_to_torch(jmodel.cfg, {"params": jgrads}).items()
                 if not k.startswith("acoustic_model.")}
    batch = {"acoustic_tokens": torch.from_numpy(ac), "semantic_tokens": torch.from_numpy(sem),
             "mask": torch.from_numpy(mask)}
    return dict(jmodel=jmodel, variables=variables, model=model, batch=batch,
                jloss=float(jl), jgrads=jgrads, ref_grads=ref_grads)


def _port_loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    out = model.forward_train(batch["acoustic_tokens"], batch["semantic_tokens"],
                              mask_override=batch["mask"])
    out["loss"].backward()
    return out, {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}


def test_loss_and_every_trainable_gradient_match_jax(setup):
    out, grads = _port_loss_and_grads(setup["model"], setup["batch"])
    assert abs(out["loss"].item() - setup["jloss"]) <= 1e-5 * abs(setup["jloss"])
    assert out["n_masked"].item() == int(setup["batch"]["mask"].sum())
    ref = setup["ref_grads"]
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], err_msg=name, **GRAD_TOL)
    codec = setup["model"].acoustic_model
    assert all(not p.requires_grad and p.grad is None for p in codec.parameters())


def test_optimizer_steps_match_optax(setup):
    """Three updates from JAX's gradients on both sides: the first at lr 0
    (count 0 of the warmup), clipping active (norm above CLIP), the codec
    frozen."""
    jmodel, model = setup["jmodel"], setup["model"]
    schedule = warmup_cosine_schedule(LR, WARMUP, TOTAL)
    j_sched = j_schedule(LR, WARMUP, TOTAL)
    for count in range(TOTAL + 2):
        # optax evaluates in f32: 1e-6 of the peak rate
        assert schedule(count) == pytest.approx(float(j_sched(count)), rel=1e-6, abs=1e-6 * LR)

    params = {k: v for k, v in setup["variables"]["params"].items()}
    tx = j_adamw(j_sched, b1=0.8, b2=0.99, eps=1e-8, weight_decay=0.01, grad_clip=CLIP,
                 frozen_mask=freeze_subtree_mask(params, "codec"))
    state = tx.init(params)
    jgrads = {**setup["jgrads"], "codec": jax.tree_util.tree_map(jnp.zeros_like, params["codec"])}
    for _ in range(3):
        updates, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
    ref = s2a_to_torch(jmodel.cfg, {"params": params})

    torch_model = s2a_pair(seed=3)[2]
    freeze_submodule(torch_model, "acoustic_model")
    codec_before = {k: v.clone() for k, v in torch_model.acoustic_model.state_dict().items()}
    opt = AdamW(torch_model.named_parameters(), schedule, b1=0.8, b2=0.99, eps=1e-8,
                weight_decay=0.01, max_grad_norm=CLIP)
    for _ in range(3):
        for n, p in opt.named:
            p.grad = torch.from_numpy(setup["ref_grads"][n].copy())
        metrics = opt.step()
    assert metrics["grad_norm"].item() > CLIP
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(optax.global_norm(
        {k: v for k, v in setup["jgrads"].items() if k != "codec"})), rtol=1e-5)
    for n, p in torch_model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), ref[n], err_msg=n, **PARAM_TOL)
    for k, v in torch_model.acoustic_model.state_dict().items():
        torch.testing.assert_close(v, codec_before[k], rtol=0, atol=0)


def _trainer(model, out_dir, **kw):
    kw = {**dict(per_device_train_batch_size=B, learning_rate=LR, warmup_steps=WARMUP,
                 max_steps=TOTAL, max_grad_norm=CLIP, logging_steps=1, save_steps=1000), **kw}
    args = TrainingArguments(output_dir=str(out_dir), **kw)

    def loss_fn(batch, generator):
        out = model.forward_train(batch["acoustic_tokens"], batch["semantic_tokens"],
                                  generator=generator, mask_override=batch.get("mask"))
        return out["loss"], {"loss_weight": out["n_masked"]}

    return Trainer(args, model, loss_fn, device="cpu")


def test_two_micro_batches_equal_one_full_batch(setup, tmp_path):
    """sum_i(w_i g_i) / sum_i(w_i) with w_i the masked counts: the
    full-batch gradient, the JAX accumulation's rule."""
    results = []
    for n_micro in (1, 2):
        model = s2a_pair(seed=3)[2]
        freeze_submodule(model, "acoustic_model")
        trainer = _trainer(model, tmp_path / f"m{n_micro}", micro_batches=n_micro)
        metrics = trainer.train_step(setup["batch"], 0)
        results.append((metrics, {n: p.grad for n, p in trainer.optimizer.named}))
    (m1, g1), (m2, g2) = results
    np.testing.assert_allclose(m2["loss"].item(), setup["jloss"], rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-5)
    for n, g in g2.items():
        torch.testing.assert_close(g, g1[n], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), setup["ref_grads"][n], err_msg=n, **GRAD_TOL)


def test_resume_reproduces_the_next_step(tmp_path):
    """A run stopped after its step-2 checkpoint and resumed draws the same
    mask and dropout at step 3 and gives the same loss as an unbroken run
    (dropout 0.1 here, so the step's generator matters)."""
    cfg = {**TINY_S2A, "encoder_ff_dropout": 0.1, "encoder_conv_dropout": 0.1}
    rng = np.random.default_rng(9)
    batch = {"acoustic_tokens": rng.integers(0, N, (B, Q, T)).astype(np.int32),
             "semantic_tokens": rng.integers(0, V, (B, T)).astype(np.int32)}

    def run(out_dir, max_steps):
        model = s2a_pair(seed=4, cfg=cfg)[2]
        freeze_submodule(model, "acoustic_model")
        trainer = _trainer(model, out_dir, save_steps=2, save_total_limit=None)
        trainer.args.max_steps = max_steps
        trainer.train(itertools.repeat(batch))
        return trainer

    full = run(tmp_path / "full", 3)
    losses = [r["train/loss"] for r in full.history]
    assert len(losses) == 3 and len(set(losses)) == 3
    assert sorted(os.listdir(tmp_path / "full")) == [
        "checkpoint_2", "checkpoint_3", "metrics.jsonl"]
    resumed_dir = tmp_path / "resumed"
    resumed_dir.mkdir()
    shutil.copytree(tmp_path / "full" / "checkpoint_2", resumed_dir / "checkpoint_2")
    resumed = run(resumed_dir, 3)
    assert [r["step"] for r in resumed.history] == [3]
    assert resumed.history[0]["train/loss"] == pytest.approx(losses[2], rel=1e-6)
    for (n, p), (_, q) in zip(full.model.named_parameters(), resumed.model.named_parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=n)


def test_overwrite_guard_and_unported_options(tmp_path):
    model = s2a_pair(seed=3)[2]
    (tmp_path / "stale.txt").write_text("a previous run")
    with pytest.raises(ValueError, match="not empty"):
        _trainer(model, tmp_path)
    for kw in ({"n_fsdp": 2}, {"n_seq": 2}):
        with pytest.raises(NotImplementedError):
            _trainer(model, tmp_path / "x", **kw)
    assert _trainer(model, tmp_path / "w", watch="gradients").args.watch == "gradients"


def test_export_loads_back_and_seeds_a_recipe(setup, tmp_path):
    """An exported s2a directory loads back strictly, and a recipe's
    ``acoustic_model_path`` (a codec directory) and ``warm_start_model``
    take their weights from such directories."""
    model = setup["model"]
    save_s2a(str(tmp_path / "export"), model)
    loaded = load_s2a(str(tmp_path / "export"), device="cpu")
    assert loaded.cfg == model.cfg
    own = model.state_dict()
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, own[k], rtol=0, atol=0, msg=k)

    codec = model.acoustic_model
    save_pretrained(str(tmp_path / "codec"), codec, codec.config.to_json())
    raw = {"seed": 11, "acoustic_model_path": str(tmp_path / "codec"),
           "extra_model_params": {k: v for k, v in TINY_S2A.items()}}
    for warm in (False, True):
        built = build_model({**raw, "warm_start_model": str(tmp_path / "export")} if warm else raw,
                            "cpu")
        assert built.cfg == model.cfg
        for k, v in built.state_dict().items():
            if warm or k.startswith("acoustic_model."):
                torch.testing.assert_close(v, own[k], rtol=0, atol=0, msg=k)
        assert not any(p.requires_grad for p in built.acoustic_model.parameters())


def test_training_ops_match_jax():
    """masked_cross_entropy, masked_mean and embed_take's gradient (the JAX
    one-hot-matmul VJP against torch's index-add): atol/rtol 1e-6, f32.
    The port's cosine_schedule_mask keeps one rate cos(u) per row, with
    E[cos u] = 2/pi for u ~ U(0, pi/2)."""
    from edm_tts_tpu.ops.embedding import embed_take as j_embed_take
    from edm_tts_tpu.ops.embedding import masked_cross_entropy as j_mce
    from edm_tts_tpu.ops.masking import masked_mean as j_masked_mean
    from edm_tts_tpu_torch import ops

    rng = np.random.default_rng(11)
    logits = rng.standard_normal((3, 4, 7, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (3, 4, 7)).astype(np.int32)
    mask = rng.random((3, 4, 7)) < 0.4
    for m in (mask, np.zeros_like(mask)):
        np.testing.assert_allclose(
            ops.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                     torch.from_numpy(m)).item(),
            float(j_mce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(m))),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            ops.masked_mean(torch.from_numpy(logits[..., 0]), torch.from_numpy(m)).item(),
            float(j_masked_mean(jnp.asarray(logits[..., 0]), jnp.asarray(m))),
            rtol=1e-6, atol=1e-6)

    table = rng.standard_normal((9, 5)).astype(np.float32)
    ids = rng.integers(0, 9, (4, 6))
    g = rng.standard_normal((4, 6, 5)).astype(np.float32)
    ref = jax.grad(lambda t: jnp.sum(j_embed_take(t, jnp.asarray(ids)) * g))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    (ops.embed_take(tt, torch.from_numpy(ids)) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

    m = ops.cosine_schedule_mask(torch.Generator().manual_seed(0), 4000, 256)
    rates = m.float().mean(1)
    assert m.dtype == torch.bool and m.shape == (4000, 256)
    assert abs(rates.mean().item() - 2 / np.pi) < 0.02
    assert rates.min().item() < 0.1 and rates.max().item() > 0.9


def test_nonfinite_skip_preemption_and_eval(tmp_path):
    """A non-finite gradient leaves weights and moments alone but advances
    the count (the JAX guard's rule); a preemption signal checkpoints the
    step and stops; evaluation runs at eval_steps without gradients."""
    opt_model = s2a_pair(seed=3)[2]
    freeze_submodule(opt_model, "acoustic_model")
    opt = AdamW(opt_model.named_parameters(), warmup_cosine_schedule(LR, 0, TOTAL))
    before = [p.detach().clone() for p in opt.params]
    for p in opt.params:
        p.grad = torch.full_like(p, float("nan"))
    metrics = opt.step(skip_nonfinite=True)
    assert metrics["skipped_nonfinite"].item() == 1.0 and opt.count == 1
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    assert not any(m.any() for m in opt.mu)

    model = s2a_pair(seed=5)[2]
    freeze_submodule(model, "acoustic_model")
    rng = np.random.default_rng(2)
    batch = {"acoustic_tokens": rng.integers(0, N, (B, Q, T)).astype(np.int32),
             "semantic_tokens": rng.integers(0, V, (B, T)).astype(np.int32)}
    trainer = _trainer(model, tmp_path, eval_steps=1)
    trainer.eval_fn = lambda b: {"loss": model.forward_train(
        b["acoustic_tokens"], b["semantic_tokens"],
        generator=torch.Generator().manual_seed(0), train=False)["loss"]}

    def batches():
        for i in itertools.count():
            if i == 2:  # the signal lands as step 3 reads its batch
                trainer.guard.trigger()
            yield batch

    trainer.train(batches(), eval_iter=[batch])
    assert [r["step"] for r in trainer.history] == [1, 1, 2, 2, 3, 3]
    assert sum("eval/loss" in r for r in trainer.history) == 3
    assert trainer.ckpt.latest_step() == 3 and trainer.last_save["step"] == 3
