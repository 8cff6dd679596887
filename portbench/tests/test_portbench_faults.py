"""Whole runs at tiny sizes on the CPU (the harness's look for a card
skipped), with the timed path broken underneath: every fault a cell can
have must turn ``correct`` false. And the window's arithmetic: a stall
planted in the window must lower the rate and raise the tail.

The faults: a token altered where it is produced, half of the batch left
out (its rows served from the other half), the speaker prompt altered in
an s2a pass after the first, a training step that returns
its state unchanged, half of the batch left out of the step's mean. One
chip, so no exchange between chips to leave out."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny
from portbench.traffic import offline_batches, open_loop, train_steps


def _correct(run) -> bool:
    return bool(run.checks) and all(c.ok for c in run.checks)


def test_sound_runs_are_correct():
    assert _correct(offline_batches.run(tiny.context(tiny.OFFLINE, tiny.SERVE_CONFIG)))
    assert _correct(train_steps.run(tiny.context(tiny.TRAIN, tiny.TRAIN_CONFIG)))


def _alter_tokens(monkeypatch):
    """The t2s sampler's last draw of every call gives each position its
    least likely token."""
    from edm_tts_tpu_torch.models.t2s import sampler

    real = sampler.positional_categorical
    draws = []

    def altered(seed, logits, row_offset=0):
        draws.append(1)
        out = real(seed, logits, row_offset)
        return logits.argmin(-1) if len(draws) % 3 == 0 else out

    monkeypatch.setattr(sampler, "positional_categorical", altered)


def _half_the_batch(monkeypatch):
    """Each call computes its first half of rows and serves those answers
    for the second half too."""
    from edm_tts_tpu_torch.serving import TTSEngine

    real = TTSEngine.synthesize

    def half(self, texts, speaker, *, seed=0, gt_lengths=None):
        k = max(1, len(texts) // 2)
        texts = list(texts[:k]) + list(texts[:len(texts) - k])
        if gt_lengths is not None:
            gt_lengths = list(gt_lengths[:k]) + list(gt_lengths[:len(texts) - k])
        return real(self, texts, speaker, seed=seed, gt_lengths=gt_lengths)

    monkeypatch.setattr(TTSEngine, "synthesize", half)


def _alter_prompt(monkeypatch):
    """The full s2a pass is handed its speaker prompt scaled by 1.1: only
    the prompt positions of its input differ from what the request
    allows (planted above the benchmark's recorder, which keeps that
    input as the program built it)."""
    from portbench import serving

    real = serving.Recorder.__init__
    tp = tiny.SERVE_CONFIG["assumed"]["prompt_frames"]

    def init(self, t2s, s2a):
        real(self, t2s, s2a)
        inner = s2a.forward_logits

        def altered(x, **kwargs):
            x = x.clone()
            x[:, :tp] *= 1.1
            return inner(x, **kwargs)

        s2a.forward_logits = altered

    monkeypatch.setattr(serving.Recorder, "__init__", init)


@pytest.mark.parametrize("fault", [_alter_tokens, _half_the_batch, _alter_prompt])
@pytest.mark.parametrize("cell", ["offline", "open"])
def test_serving_faults_turn_correct_false(monkeypatch, fault, cell):
    fault(monkeypatch)
    if cell == "offline":
        run = offline_batches.run(tiny.context(tiny.OFFLINE, tiny.SERVE_CONFIG))
    else:
        run = open_loop.run(tiny.context(tiny.OPEN, tiny.SERVE_CONFIG, seconds=1.0))
    assert not _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


def _state_unchanged(monkeypatch):
    from edm_tts_tpu_torch.train.optim import AdamW

    def apply(self, g, *, skip_nonfinite=False):
        self.count += 1
        return {"grad_norm": self.global_norm(g), "lr": torch.tensor(0.0)}

    monkeypatch.setattr(AdamW, "apply", apply)


def _half_of_the_step(monkeypatch):
    from edm_tts_tpu_torch.train import trainer

    real = trainer.Trainer._weighted_sums

    def half(self, batch, step_seed, n_micro, first):
        rows = next(iter(batch.values())).shape[0] // 2
        return real(self, {k: v[:rows] for k, v in batch.items()}, step_seed, n_micro, first)

    monkeypatch.setattr(trainer.Trainer, "_weighted_sums", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_of_the_step])
def test_training_faults_turn_correct_false(monkeypatch, fault):
    fault(monkeypatch)
    run = train_steps.run(tiny.context(tiny.TRAIN, tiny.TRAIN_CONFIG))
    assert not _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


def _stall(monkeypatch, seconds: float, at_call: int):
    from edm_tts_tpu_torch.serving import TTSEngine

    real = TTSEngine.synthesize
    calls = []

    def stalled(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == at_call:
            time.sleep(seconds)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(TTSEngine, "synthesize", stalled)


def test_a_stall_lowers_the_offline_rate(monkeypatch):
    spec = {**tiny.OFFLINE, "check": {"calls": 1, "among": 1, "rows_per_block": 4}}
    rate = harness.metric_module("audio_s_per_s")
    calm = rate.read(offline_batches.run(tiny.context(spec, tiny.SERVE_CONFIG, seconds=1.0)))
    _stall(monkeypatch, 1.0, at_call=3)  # the window's first call, after two warm-ups
    stalled = rate.read(offline_batches.run(tiny.context(spec, tiny.SERVE_CONFIG, seconds=1.0)))
    assert stalled < 0.8 * calm, (calm, stalled)


def test_a_stall_raises_the_open_loop_tail(monkeypatch):
    spec = {**tiny.OPEN, "check": {"requests": 0, "rows_per_block": 4}}
    spec["traffic"] = {**spec["traffic"], "rate": 4.0}
    p95 = harness.metric_module("latency_p95_s")
    calm = p95.read(open_loop.run(tiny.context(spec, tiny.SERVE_CONFIG, seconds=3.0)))
    _stall(monkeypatch, 3.0, at_call=6)
    stalled = p95.read(open_loop.run(tiny.context(spec, tiny.SERVE_CONFIG, seconds=3.0)))
    assert stalled > calm + 1.0, (calm, stalled)
