"""The port's t2s training against the JAX package's, on the CPU in f32.

Same weights on both sides (``t2s_pair``: tiny t2s, dropout 0) and the same
mask (``mask_override``: torch cannot reproduce ``jax.random``).
Tolerances: the loss and its two terms to a relative 1e-5; each trainable
gradient as in tests/test_torch_s2a_train.py (atol 2e-6 + rtol 1e-4: f32,
another summation order through 3 blocks, the heads and the
cross-entropy). The JAX gradient tree goes through the package's own
``to_torch_state_dict`` to reference names. Also: the collators equal the
JAX ones, the mask draw's masked share follows ``cos u``, an export loads
back and samples the same tokens, accumulation over micro-batches, and
``run_t2s.main_from_dict`` end to end (train, evaluate, checkpoint, resume,
export, ``preprocessing_only``).
"""

import itertools
import math
import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.data import collators as j_collators
from edm_tts_tpu.models.t2s.convert import to_torch_state_dict as t2s_to_torch
from edm_tts_tpu_torch.data import collators
from edm_tts_tpu_torch.data.token_shards import TokenShardWriter
from edm_tts_tpu_torch.models.t2s import t2s_sample
from edm_tts_tpu_torch.train import run_t2s
from edm_tts_tpu_torch.train.export import load_t2s, save_t2s
from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments
from torch_port_parity import TINY_T2S, t2s_pair

V = TINY_T2S["semantic_vocab_size"]
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)


def _examples(rng, n, sem_range=(4, 30), zero_share=0.2):
    """Seeded items: semantic tokens in [0, V) (some 0, which the loss
    leaves out) and text bytes shorter than the speech."""
    out = []
    for i in range(n):
        t = int(rng.integers(*sem_range))
        sem = rng.integers(1, V, t)
        sem[rng.random(t) < zero_share] = 0
        out.append({"id": f"u{i}", "semantic_tokens": sem,
                    "transcription_bytes": [int(b) for b in rng.integers(0, 256, int(rng.integers(1, t)))]})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    jmodel, variables, model = t2s_pair(seed=7)
    rng = np.random.default_rng(1)
    batch = collators.collate_t2s(_examples(rng, 3))
    mask = rng.random(batch["input_ids"].shape) < 0.5

    def jloss(params):
        out = jmodel.apply({"params": params}, *(jnp.asarray(batch[k]) for k in run_t2s.BATCH_KEYS),
                           mask_rng=jax.random.PRNGKey(0), mask_override=jnp.asarray(mask),
                           train=True)
        return out["loss"], out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    ref_grads = t2s_to_torch(jmodel.cfg, {"params": jgrads})
    return dict(model=model, batch=_torch_batch(batch), mask=torch.from_numpy(mask),
                jout={k: np.asarray(v) for k, v in jout.items()}, ref_grads=ref_grads)


def test_loss_and_every_trainable_gradient_match_jax(setup):
    model, batch = setup["model"], setup["batch"]
    model.zero_grad(set_to_none=True)
    out = model.forward_train(*(batch[k] for k in run_t2s.BATCH_KEYS),
                              mask_override=setup["mask"], generator=torch.Generator().manual_seed(0))
    out["loss"].backward()
    jout = setup["jout"]
    for k in ("loss", "ce_loss", "length_loss"):
        assert abs(out[k].item() - float(jout[k])) <= 1e-5 * abs(float(jout[k])), k
    np.testing.assert_array_equal(out["mask"].numpy(), jout["mask"])
    assert out["mask"].any() and not (out["mask"] & ~batch["speech_mask"]).any()
    grads = {n: p.grad for n, p in model.named_parameters()}
    ref = setup["ref_grads"]
    assert set(grads) <= set(ref) and len(grads) > 40
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], err_msg=name, **GRAD_TOL)


def test_collators_equal_jax():
    """t2s_filter, collate_t2s and length_bucketed (both its sorted pools
    and its unsorted tail) give the JAX functions' output."""
    rng = np.random.default_rng(4)
    items = _examples(rng, 300, sem_range=(2, 60))
    for ex in items[:20]:  # some that the filter drops: text as long as the speech
        ex["transcription_bytes"] = list(range(len(ex["semantic_tokens"]) + 1))
    kept = [ex for ex in items if collators.t2s_filter(ex)]
    assert kept == [ex for ex in items if j_collators.t2s_filter(ex)] and 150 < len(kept) < 280
    for kw in ({}, {"pad_to_multiple": 16}):
        out, ref = collators.collate_t2s(kept[:7], **kw), j_collators.collate_t2s(kept[:7], **kw)
        assert out.keys() == ref.keys()
        for k in out:
            assert out[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for kw in (dict(batch_size=8, pool_size=64, seed=3), dict(batch_size=5, seed=1)):
        groups = [[ex["id"] for ex in g] for g in collators.length_bucketed(iter(kept), **kw)]
        assert groups == [[ex["id"] for ex in g] for g in j_collators.length_bucketed(iter(kept), **kw)]
        assert len(groups) == len(kept) // kw["batch_size"]


def test_mask_draw_follows_cos_u(setup):
    """One rate cos(u), u ~ U(0, pi/2), per sample, restricted to the speech
    span: over 1024 samples of 56 speech positions the masked share has mean
    2/pi and E[share^2] = E[cos^2 u] + E[cos u (1 - cos u)] / 56."""
    model = setup["model"]
    b, n_speech = 1024, 56
    ex = [{"semantic_tokens": np.ones(n_speech, np.int64), "transcription_bytes": [7, 8, 9]}
          for _ in range(b)]
    batch = _torch_batch(collators.collate_t2s(ex))
    with torch.no_grad():
        out = model.forward_train(*(batch[k] for k in run_t2s.BATCH_KEYS),
                                  generator=torch.Generator().manual_seed(0), train=False)
    mask, speech = out["mask"], batch["speech_mask"]
    assert not (mask & ~speech).any() and int(speech[0].sum()) == n_speech
    share = mask.sum(1).double() / n_speech
    assert abs(share.mean().item() - 2 / math.pi) < 0.02
    want_sq = 0.5 + (2 / math.pi - 0.5) / n_speech
    assert abs(share.square().mean().item() - want_sq) < 0.02
    assert share.min().item() < 0.1 and share.max().item() > 0.9


def test_export_loads_back_and_samples_the_same_tokens(setup, tmp_path):
    model = setup["model"]
    save_t2s(str(tmp_path / "export"), model)
    loaded = load_t2s(str(tmp_path / "export"), device="cpu")
    assert loaded.cfg == model.cfg
    own = model.state_dict()
    assert loaded.state_dict().keys() == own.keys()
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, own[k], rtol=0, atol=0, msg=k)
    text = torch.tensor([[40, 41, 42, 43, 44], [50, 51, 52, 0, 0]])
    lengths = torch.tensor([5, 3])
    outs = [t2s_sample(m, text, lengths, torch.Generator().manual_seed(3), pred_iters=4,
                       max_speech_len=24, gt_length=torch.tensor([20, 13]), greedy=True)
            for m in (model, loaded)]
    torch.testing.assert_close(outs[0]["semantic_tokens"], outs[1]["semantic_tokens"], rtol=0, atol=0)


def test_two_micro_batches_equal_one_batch(setup, tmp_path):
    """The JAX accumulation weighs each t2s micro-batch by 1: the mean of
    the micro-batch gradients. With the same number of loss positions in
    each half (the same mask count, no semantic 0) and the length loss a
    mean over equal halves, that is the full batch's gradient."""
    rng = np.random.default_rng(8)
    ex = _examples(rng, 4, sem_range=(12, 13), zero_share=0.0)
    batch = _torch_batch(collators.collate_t2s(ex))
    mask = torch.zeros_like(batch["speech_mask"])
    for i in range(4):
        mask[i, torch.nonzero(batch["speech_mask"][i])[:, 0][rng.permutation(12)[:5]]] = True
    batch["mask"] = mask
    results = []
    for n_micro in (1, 2):
        model = t2s_pair(seed=7)[2]
        args = TrainingArguments(output_dir=str(tmp_path / f"m{n_micro}"), per_device_train_batch_size=4,
                                 micro_batches=n_micro, learning_rate=1e-2, warmup_steps=2)

        def loss_fn(b, generator, model=model):
            out = model.forward_train(*(b[k] for k in run_t2s.BATCH_KEYS),
                                      mask_override=b["mask"], generator=generator)
            return out["loss"], {"ce_loss": out["ce_loss"], "length_loss": out["length_loss"]}

        trainer = Trainer(args, model, loss_fn, device="cpu")
        metrics = trainer.train_step(batch, 0)
        results.append((metrics, {n: p.grad for n, p in trainer.optimizer.named}))
    (m1, g1), (m2, g2) = results
    for k in ("loss", "ce_loss", "length_loss", "grad_norm"):
        np.testing.assert_allclose(m2[k].item(), m1[k].item(), rtol=1e-5, err_msg=k)
    for n, g in g2.items():
        torch.testing.assert_close(g, g1[n], rtol=1e-4, atol=1e-6, msg=n)


def _write_shards(path, n, seed):
    rng = np.random.default_rng(seed)
    w = TokenShardWriter(str(path), items_per_shard=16)
    for i, ex in enumerate(_examples(rng, n, sem_range=(22, 40))):
        t = len(ex["semantic_tokens"])
        w.add(f"utt{i}", rng.integers(0, 16, (1, t)), ex["semantic_tokens"],
              text_bytes=ex["transcription_bytes"])
    w.close()


def _recipe(tmp_path, out, **kw):
    return {"output_dir": str(tmp_path / out), "seed": 5, "bf16": False,
            "extra_model_params": {**TINY_T2S, "main_encoder_ff_dropout": 0.1,
                                   "main_encoder_conv_dropout": 0.1},
            "dataset_args": {"data_dir": str(tmp_path / "train"), "format": "native"},
            "eval_dataset_args": {"data_dir": str(tmp_path / "eval"), "format": "native"},
            "per_device_train_batch_size": 4, "per_device_eval_batch_size": 4, "eval_batches": 2,
            "max_steps": 3, "warmup_steps": 1, "logging_steps": 1, "eval_steps": 2,
            "save_steps": 2, "save_total_limit": None, **kw}


def test_run_t2s_trains_evaluates_resumes_and_exports(tmp_path, capsys):
    """Three steps with dropout 0.1 on seeded shards, evaluation at step 2,
    checkpoints at steps 2 and 3, an export that loads back; a run given
    the step-2 checkpoint resumes there and takes step 3 only (on the first
    batch of its own stream: neither trainer skips data on resume); the
    recipe defaults are the JAX entry point's."""
    _write_shards(tmp_path / "train", 40, 0)
    _write_shards(tmp_path / "eval", 12, 1)
    assert run_t2s.main_from_dict(_recipe(tmp_path, "pre", preprocessing_only=True),
                                  device="cpu") is None
    assert "preprocessing ok" in capsys.readouterr().out
    full = run_t2s.main_from_dict(_recipe(tmp_path, "full"), device="cpu")
    train = [r for r in full.history if "train/loss" in r]
    evals = [r for r in full.history if "eval/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3] and [r["step"] for r in evals] == [2]
    assert all(np.isfinite([r["train/loss"], r["train/ce_loss"], r["train/length_loss"]]).all()
               for r in train)
    assert evals[0]["eval/loss"] == pytest.approx(evals[0]["eval/ce_loss"]
                                                  + evals[0]["eval/length_loss"], rel=1e-6)
    assert sorted(os.listdir(tmp_path / "full")) == [
        "checkpoint_2", "checkpoint_3", "export", "metrics.jsonl"]
    shutil.copytree(tmp_path / "full" / "checkpoint_2", tmp_path / "step2" / "checkpoint_2")
    resumed = run_t2s.main_from_dict(
        _recipe(tmp_path, "resumed", resume_from_checkpoint=str(tmp_path / "step2")), device="cpu")
    assert [r["step"] for r in resumed.history if "train/loss" in r] == [3]
    loaded = load_t2s(str(tmp_path / "full" / "export"), device="cpu")
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, full.model.state_dict()[k], rtol=0, atol=0, msg=k)
    args = run_t2s.training_arguments({"output_dir": "x"}, **run_t2s.T2S_DEFAULTS)
    assert (args.learning_rate, args.max_steps, args.warmup_steps, args.adam_beta1,
            args.adam_beta2, args.max_grad_norm, args.micro_batches) == (
        2.5e-4, 300_000, 4000, 0.8, 0.99, 0.5, 1)


def test_resume_reproduces_the_next_step(tmp_path):
    """The entry point's model and loss on one repeated batch, dropout 0.1:
    a run stopped after its step-2 checkpoint and resumed draws the same
    mask and dropout at step 3 as an unbroken run and ends with the same
    weights."""
    recipe = _recipe(tmp_path, "unused")
    batch = collators.collate_t2s(_examples(np.random.default_rng(6), 4, sem_range=(22, 40)))

    def run(out_dir):
        model = run_t2s.build_model(recipe, "cpu")
        _, loss_fn = run_t2s.t2s_loss(model, bf16=False)
        args = run_t2s.training_arguments({**recipe, "output_dir": str(out_dir)},
                                          **run_t2s.T2S_DEFAULTS)
        trainer = Trainer(args, model, loss_fn, device="cpu")
        trainer.train(itertools.repeat(batch))
        return trainer

    full = run(tmp_path / "full")
    losses = [r["train/loss"] for r in full.history]
    assert len(losses) == 3 and len(set(losses)) == 3
    (tmp_path / "resumed").mkdir()
    shutil.copytree(tmp_path / "full" / "checkpoint_2", tmp_path / "resumed" / "checkpoint_2")
    resumed = run(tmp_path / "resumed")
    assert [r["step"] for r in resumed.history] == [3]
    assert resumed.history[0]["train/loss"] == pytest.approx(losses[2], rel=1e-6)
    for (n, p), (_, q) in zip(full.model.named_parameters(), resumed.model.named_parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=n)


def test_t2s_batch_iterator_buckets_by_length():
    """Past the 2048-item pool each batch holds neighbours in length."""
    items = _examples(np.random.default_rng(2), 2100, sem_range=(21, 200), zero_share=0.0)
    random.Random(0).shuffle(items)
    groups = list(itertools.islice(collators.length_bucketed(iter(items), 32, seed=0), 64))
    spans = [max(len(e["semantic_tokens"]) for e in g) - min(len(e["semantic_tokens"]) for e in g)
             for g in groups]
    assert max(spans) <= 10
