"""f32 training (the recipes' ``bf16: false``) through the port's trainers
against the JAX package's, with ``watch``, a tracker and the step
annotations; K4's plain version at f32 against the Pallas backward.

The trainers: the port's ``Trainer`` with ``run_s2a.s2a_loss`` /
``run_t2s.t2s_loss`` at ``bf16=False`` and the JAX ``Trainer`` with the
JAX entry points' loss functions, on the same tiny weights
(tests/torch_port_parity.py), the same batches and the same masks (each
batch carries its ``"mask"``: torch cannot draw ``jax.random``'s), dropout
0, one device each, 3 steps with clipping active. Every step's logged loss
agrees to a relative 1e-5 (f32, another summation order). ``watch: all``:
each tensor's gradient norm within a relative 1e-4 (the gradients' own
tolerance in tests/test_torch_{s2a,t2s}_train.py) and parameter norm
within 1e-5 of JAX ``watch_metrics``'s, for every tensor the JAX package's
converter carries across as one tensor (found by converting a tree that
holds each leaf's index).

K4's plain version: ``flash_mha_bwd_reference`` against the Pallas
``flash_mha_bwd`` in interpret mode (blocks of 16, so the ragged T goes
through their padding) at the f32 kernel's head depths, atol/rtol 1e-5, as
tests/test_torch_attention_grad.py holds the other depths.
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.s2a.convert import to_torch_state_dict as s2a_to_torch
from edm_tts_tpu.models.t2s.convert import to_torch_state_dict as t2s_to_torch
from edm_tts_tpu.ops.pallas_attention import flash_mha as j_flash_mha
from edm_tts_tpu.ops.pallas_attention import flash_mha_bwd as j_flash_mha_bwd
from edm_tts_tpu.parallel.mesh import make_mesh
from edm_tts_tpu.train import watch as j_watch
from edm_tts_tpu.train.optim import freeze_subtree_mask
from edm_tts_tpu.train.trainer import Trainer as JTrainer
from edm_tts_tpu.train.trainer import TrainingArguments as JTrainingArguments
from edm_tts_tpu.utils import logging as j_logging
from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.data import collators
from edm_tts_tpu_torch.train import run_s2a, run_t2s, watch
from edm_tts_tpu_torch.train.optim import freeze_submodule
from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments
from edm_tts_tpu_torch.utils import logging as port_logging
from edm_tts_tpu_torch.utils.profiling import TRACE_NAME, span, trace
from edm_tts_tpu_torch.utils.trackers import MemoryTracker
from torch_port_parity import s2a_pair, t2s_pair

STEPS = 3
LOOP = dict(per_device_train_batch_size=4, learning_rate=1e-2, warmup_steps=1, max_steps=STEPS,
            max_grad_norm=0.05, logging_steps=1, save_steps=1000, adam_beta1=0.8,
            adam_beta2=0.99, watch="all")
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
PARAM_NORM_RTOL = 1e-5


def _one_to_one(to_torch, cfg, variables) -> dict[str, str]:
    """{port name: JAX watch path} for each tensor the converter makes from
    exactly one JAX leaf, unchanged but for its layout."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(variables)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    paths = {i + 1: j_watch._leaf_name(path) for i, (path, _) in enumerate(leaves)}
    sizes = {i + 1: leaf.size for i, (_, leaf) in enumerate(leaves)}
    out = {}
    for name, x in to_torch(cfg, marked).items():
        values = np.unique(np.asarray(x))
        if values.size == 1 and values[0] in paths and sizes[values[0]] == np.asarray(x).size:
            out[name] = paths[values[0]]
    return out


def _jax_records(out_dir) -> list[dict]:
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _run_both(tmp_path, jmodel, variables, model, batches, j_loss, port_loss_fn, frozen=None):
    """Both trainers over ``batches`` (dicts of numpy arrays); returns their
    logged train records and the port trainer."""
    jtrainer = JTrainer(JTrainingArguments(output_dir=str(tmp_path / "jax"), **LOOP), j_loss,
                        variables, frozen_mask=frozen, mesh=make_mesh(devices=jax.devices()[:1]))
    jtrainer.train(iter(batches))
    trainer = Trainer(TrainingArguments(
        output_dir=str(tmp_path / "port"), trackers=("edm_tts_tpu_torch.utils.trackers:make_tracker",),
        **LOOP), model, port_loss_fn, device="cpu")
    trainer.train(iter(batches))
    return _jax_records(tmp_path / "jax"), trainer


def _compare(jrecords, trainer, names: dict[str, str]) -> None:
    records = [r for r in trainer.history if "train/loss" in r]
    assert [r["step"] for r in records] == [r["step"] for r in jrecords] == [1, 2, 3]
    tracked = trainer.metrics.trackers[0]
    assert isinstance(tracked, MemoryTracker) and len(tracked.scalars) == STEPS
    for r, jr, (step, scalars) in zip(records, jrecords, tracked.scalars):
        assert abs(r["train/loss"] - jr["train/loss"]) <= LOSS_RTOL * abs(jr["train/loss"])
        assert step == r["step"] and scalars == {k: v for k, v in r.items()
                                                  if k not in ("step", "time")}
        for name, path in names.items():
            for kind, rtol in (("grad_norm", GRAD_NORM_RTOL), ("param_norm", PARAM_NORM_RTOL)):
                np.testing.assert_allclose(r[f"train/watch/{kind}/{name}"],
                                           jr[f"train/watch/{kind}/{path}"], rtol=rtol,
                                           err_msg=f"step {r['step']} {kind} {name}")
    trainable = [n for n, _ in trainer.optimizer.named]
    watched = {k.split("/", 3)[3] for k in records[0] if k.startswith("train/watch/grad_norm/")}
    assert watched == set(trainable) and set(names) <= watched and len(names) > 20


def test_s2a_f32_steps_match_jax_trainer(tmp_path):
    jmodel, variables, model = s2a_pair(seed=3)
    freeze_submodule(model, "acoustic_model")
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(STEPS):
        mask = rng.random((4, 12)) < 0.5
        mask[:, 0] = True
        batches.append({"acoustic_tokens": rng.integers(0, 16, (4, 4, 12)).astype(np.int32),
                        "semantic_tokens": rng.integers(0, 8, (4, 12)).astype(np.int32),
                        "mask": mask})

    def j_loss(p, batch, rng):  # run_semantic_to_acoustic_training's, the mask given
        out = jmodel.apply(p, batch["acoustic_tokens"], batch["semantic_tokens"],
                           mask_rng=rng, mask_override=batch["mask"], train=True)
        return out["loss"], {"loss_weight": jnp.sum(out["mask"])}

    _, loss_fn = run_s2a.s2a_loss(model, bf16=False)
    jrecords, trainer = _run_both(tmp_path, jmodel, variables, model, batches, j_loss, loss_fn,
                                  freeze_subtree_mask(variables, "codec"))
    names = _one_to_one(s2a_to_torch, jmodel.cfg, variables)
    _compare(jrecords, trainer, {n: p for n, p in names.items()
                                 if not n.startswith("acoustic_model.")})


def test_t2s_f32_steps_match_jax_trainer(tmp_path):
    jmodel, variables, model = t2s_pair(seed=7)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS):
        examples = []
        for i in range(4):
            t = int(rng.integers(6, 30))
            examples.append({"id": f"u{i}", "semantic_tokens": rng.integers(1, 8, t),
                             "transcription_bytes": rng.integers(0, 256, int(rng.integers(1, t))
                                                                 ).tolist()})
        batch = collators.collate_t2s(examples)
        batch["mask"] = (rng.random(batch["input_ids"].shape) < 0.5) & batch["speech_mask"]
        batches.append(batch)

    def j_loss(p, batch, rng):  # run_text_to_semantic_training's, the mask given
        out = jmodel.apply(p, *(batch[k] for k in run_t2s.BATCH_KEYS), mask_rng=rng,
                           mask_override=batch["mask"], train=True)
        return out["loss"], {"ce_loss": out["ce_loss"], "length_loss": out["length_loss"]}

    _, loss_fn = run_t2s.t2s_loss(model, bf16=False)
    jrecords, trainer = _run_both(tmp_path, jmodel, variables, model, batches, j_loss, loss_fn)
    _compare(jrecords, trainer, _one_to_one(t2s_to_torch, jmodel.cfg, variables))
    for r, jr in zip([r for r in trainer.history if "train/loss" in r], jrecords):
        for k in ("train/ce_loss", "train/length_loss"):
            assert abs(r[k] - jr[k]) <= LOSS_RTOL * abs(jr[k]) + 1e-7, k


def test_watch_modes_and_logging_copies_equal_jax():
    grads = {"a.weight": torch.tensor([3.0, 4.0]), "b": torch.ones(2, 2)}
    params = {"a.weight": torch.tensor([[1.0, 2.0], [2.0, 4.0]])}
    out = watch.watch_metrics("all", grads=grads, params=params)
    assert {k: round(v.item(), 6) for k, v in out.items()} == {
        "watch/grad_norm/a.weight": 5.0, "watch/grad_norm/b": 2.0, "watch/param_norm/a.weight": 5.0}
    assert set(watch.watch_metrics("gradients", grads=grads, params=params)) == {
        "watch/grad_norm/a.weight", "watch/grad_norm/b"}
    assert watch.watch_metrics(None, grads=grads) == watch.watch_metrics("false", grads=grads) == {}
    with pytest.raises(ValueError, match="not in"):
        watch.watch_metrics("histograms", grads=grads)
    assert watch.WATCH_MODES == j_watch.WATCH_MODES
    for name in ("Tracker", "tracker_from_spec", "setup_logging"):
        assert (inspect.getsource(getattr(port_logging, name))
                == inspect.getsource(getattr(j_logging, name))), name
    for name in ("add_tracker", "log_audio", "_safe"):
        assert (inspect.getsource(getattr(port_logging.MetricLogger, name))
                == inspect.getsource(getattr(j_logging.MetricLogger, name))), name
    tracker = port_logging.tracker_from_spec("edm_tts_tpu_torch.utils.trackers:make_tracker")
    assert isinstance(tracker, port_logging.Tracker)


def test_tracker_gets_every_record_and_a_failing_one_is_ignored(tmp_path):
    class Broken:
        def log_scalars(self, step, scalars):
            raise RuntimeError("the service is down")

        def log_audio(self, step, name, waveform, sample_rate):
            raise RuntimeError("the service is down")

        def close(self):
            raise RuntimeError("the service is down")

    good = MemoryTracker()
    logger = port_logging.MetricLogger(str(tmp_path), trackers=[Broken(), good])
    record = logger.log(7, {"loss": torch.tensor(0.5), "name": "not a number"}, prefix="train/")
    logger.log_audio(7, "sample", np.zeros(4), 16000)
    logger.close()
    assert good.scalars == [(7, {"train/loss": 0.5})] and record["train/loss"] == 0.5
    assert good.audio == [(7, "sample", 16000)] and good.closed
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["train/loss"] == 0.5


def test_trace_names_each_training_step(tmp_path):
    """A profiler trace around 3 steps of the port's trainer holds one
    ``train.step`` range per step and the phases of each."""
    model = s2a_pair(seed=3)[2]
    freeze_submodule(model, "acoustic_model")
    _, loss_fn = run_s2a.s2a_loss(model, bf16=False)
    rng = np.random.default_rng(0)
    batches = [{"acoustic_tokens": rng.integers(0, 16, (2, 4, 12)).astype(np.int32),
                "semantic_tokens": rng.integers(0, 8, (2, 12)).astype(np.int32)}
               for _ in range(3)]
    args = TrainingArguments(output_dir=str(tmp_path / "out"), **{
        **LOOP, "per_device_train_batch_size": 2, "watch": None})
    trainer = Trainer(args, model, loss_fn, device="cpu")
    with trace(str(tmp_path / "prof")):
        trainer.train(iter(batches))
    events = json.loads((tmp_path / "prof" / TRACE_NAME).read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert names.count("train.step") == 3
    for phase in ("train.forward", "train.backward", "train.reduce", "train.optimizer"):
        assert names.count(phase) == 3, phase
    with span("eval.step") as s:  # outside a trace it records nothing
        assert s is None


@pytest.mark.parametrize("t,lens,d", [(35, (30, 35), 20), (24, (17, 24), 24), (40, None, 12)])
def test_backward_reference_matches_pallas_at_f32_depths(t, lens, d):
    rng = np.random.default_rng(t + d)
    q, k, v, g = (rng.standard_normal((2, t, 3, d)).astype(np.float32) for _ in range(4))
    mask = None if lens is None else np.arange(t)[None, :] < np.array(lens)[:, None]
    jm = None if mask is None else jnp.asarray(mask)
    o, lse = j_flash_mha(*map(jnp.asarray, (q, k, v)), mask=jm, block_q=16, interpret=True,
                         return_lse=True)
    ref = j_flash_mha_bwd(*map(jnp.asarray, (q, k, v)), jm, o, lse, jnp.asarray(g),
                          block_q=16, block_k=16, interpret=True)
    tm = None if mask is None else torch.from_numpy(mask)
    out = ops.flash_mha_bwd(*(torch.from_numpy(x) for x in (q, k, v)), tm,
                            torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))[..., 0],
                            torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5, err_msg=name)
