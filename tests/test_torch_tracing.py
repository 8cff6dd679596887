"""The port's spans (``utils/profiling.py``) and where the program records
them: the batcher's request phases, the engine's stages and canvas counts,
the trainer's phases. CPU, tiny models."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
from edm_tts_tpu_torch.models.t2s import T2SConfig, TextToSemantic
from edm_tts_tpu_torch.serving import TTSEngine
from edm_tts_tpu_torch.serving.batcher import DynamicBatcher, Request
from edm_tts_tpu_torch.train.run_s2a import s2a_loss
from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments
from edm_tts_tpu_torch.utils import profiling
from edm_tts_tpu_torch.utils.profiling import add_span, recording, span

T2S = dict(hidden_size=32, semantic_vocab_size=8, main_encoder_num_heads=2,
           main_encoder_dim_head=12, main_encoder_num_layers=2, length_predictor_num_heads=2,
           length_predictor_dim_head=12, length_predictor_num_layers=1)
CODEC = dict(encoder_dim=4, decoder_dim=32, n_codebooks=4, codebook_size=16, codebook_dim=4,
             quantizer_dropout=0.0)
S2A = dict(hidden_size=32, num_semantic_tokens=8, encoder_num_heads=4, encoder_num_layers=4,
           injection_layers=(1, 2), encoder_attn_dropout=0.0, encoder_ff_dropout=0.0,
           encoder_conv_dropout=0.0, codec=CODEC)


def _nearest_rank(values, q):
    return sorted(values)[max(0, -(-len(values) * q // 100) - 1)]


def test_off_records_nothing_and_opens_no_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("off.outer", rows=3) as s:
            assert s is None
            torch.ones(4).sum()
        assert add_span("off.interval", 0.0, 1.0) is None
    assert not {"off.outer", "off.interval"} & {e.name for e in prof.events()}
    assert span("a") is span("b")  # one shared no-op context


def test_spans_nest_and_take_their_parents():
    with recording() as log:
        with span("outer", step=7) as outer:
            with span("inner", requests=[3, 4]) as inner:
                inner.counts["rows"] = 2
            with pytest.raises(ValueError):
                with span("raises"):
                    raise ValueError("inside a span")
            with span("after"):
                pass
        with span("top"):
            pass
    by = {s.name: s for s in log.spans}
    assert [s.name for s in log.spans] == ["inner", "raises", "after", "outer", "top"]  # by end
    assert by["outer"].parent is None and by["top"].parent is None
    assert by["inner"].parent == by["raises"].parent == by["after"].parent == outer.id
    assert by["inner"].requests == (3, 4) and by["inner"].counts == {"rows": 2}
    assert by["outer"].counts == {"step": 7}
    assert by["outer"].start <= by["inner"].start <= by["inner"].end <= by["outer"].end
    assert len({s.id for s in log.spans}) == 5
    assert profiling._log is None and span("later") is profiling._OFF


def test_recording_nests_and_the_log_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "LOG_LIMIT", 3)
    with recording() as log:
        with recording() as same:
            assert same is log
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [s.name for s in log.spans] == ["s0", "s1", "s2"] and log.dropped == 2


def test_add_span_across_threads():
    stamps = {"submit": time.perf_counter()}
    with recording() as log:
        with span("call") as call:
            def worker():
                stamps["taken"] = time.perf_counter()
                stamps["id"] = add_span("queued", stamps["submit"], stamps["taken"],
                                        parent=call.id, requests=(5,), rows=1)
                with span("on.worker"):
                    pass

            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
            assert not t.is_alive()
    by = {s.name: s for s in log.spans}
    q = by["queued"]
    assert q.id == stamps["id"] and (q.start, q.end) == (stamps["submit"], stamps["taken"])
    assert q.parent == call.id and q.requests == (5,) and q.counts == {"rows": 1}
    assert q.thread == by["on.worker"].thread != by["call"].thread
    assert by["on.worker"].parent is None  # the stack is the worker thread's own


def test_trace_holds_a_span_opened_on_a_worker_thread(tmp_path):
    if profiling.all_threads_config() is None:
        pytest.skip("this torch profiles the starting thread alone")

    def worker():
        with span("worker.phase"):
            torch.ones(8).sum()

    with profiling.trace(str(tmp_path)):
        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    assert "worker.phase" in {e.get("name") for e in events}


def test_batcher_request_phases_add_up_to_each_call():
    """Behind a stub engine: each request's queued + held span from its
    submit to the start of its call, every request id is in exactly one
    ``batcher.call``, the engine's span is the call's child, and the
    ``/stats`` tails come from the same stamps."""
    release = threading.Event()

    def synth(texts, speaker, seed=0, gt_lengths=None):
        if texts == ["blocker"]:
            release.wait(30)
        with span("stub.engine"):
            time.sleep(0.002)
        return [np.zeros(len(t), np.float32) for t in texts]

    with recording() as log:
        b = DynamicBatcher(synth, max_batch=3, max_wait_ms=20, lookahead=2)
        try:
            first = b.submit(Request("blocker", "a"))
            futs = [b.submit(Request("x" * (i + 1), "a" if i % 3 else "b", seed=i % 2))
                    for i in range(11)]
            release.set()
            for f in [first] + futs:
                f.result(30)
            stats = b.stats()
        finally:
            b.close()
    calls = log.named("batcher.call")
    queued = {s.requests[0]: s for s in log.named("batcher.queued")}
    held = {s.requests[0]: s for s in log.named("batcher.held")}
    assert sorted(queued) == sorted(held) == list(range(12))
    owners = {}
    for c in calls:
        for rid in c.requests:
            assert rid not in owners
            owners[rid] = c
    assert sorted(owners) == list(range(12)) and stats["engine_calls"] == len(calls)
    for rid, c in owners.items():
        q, h = queued[rid], held[rid]
        assert q.end == h.start and h.end == c.start
        assert (q.end - q.start) + (h.end - h.start) == pytest.approx(c.start - q.start,
                                                                      abs=1e-9)
    engine = log.named("stub.engine")
    assert sorted(s.parent for s in engine) == sorted(c.id for c in calls)
    collects = log.named("batcher.collect")  # the worker's, each call after one
    assert {s.thread for s in collects} == {c.thread for c in calls}
    assert all(any(k.end <= c.start for k in collects) for c in calls)
    assert stats["queued_s_p95"] == _nearest_rank([q.end - q.start for q in queued.values()], 95)
    assert stats["held_s_p50"] == _nearest_rank([h.end - h.start for h in held.values()], 50)
    assert stats["latency_s_p95"] >= stats["latency_s_p50"] > 0
    assert stats["latency_s_p95"] <= stats["latency_s_max"]


def test_batcher_stats_tails_without_requests():
    b = DynamicBatcher(lambda texts, speaker, **kw: [np.zeros(1)] * len(texts))
    try:
        stats = b.stats()
    finally:
        b.close()
    for name in ("queued", "held", "latency"):
        assert stats[f"{name}_s_p50"] == stats[f"{name}_s_p95"] == 0.0


@pytest.fixture(scope="module")
def tiny_engine():
    torch.manual_seed(0)
    t2s = TextToSemantic(T2SConfig.from_dict(T2S)).eval()
    s2a = InjectionConformer(S2AConfig.from_dict(S2A)).eval()
    engine = TTSEngine.from_models(t2s, s2a, device="cpu", pred_iters=2, s2a_steps=2,
                                   max_speech_len=16, text_bucket=8, length_bucket=8,
                                   batch_buckets=(1, 2, 4))
    rng = np.random.default_rng(0)
    engine.register_speaker_codes("p", rng.integers(0, 16, (1, 4, 5)), rng.integers(0, 8, (1, 5)))
    return engine


@pytest.mark.parametrize("gt_lengths", [[9, 16, 4], None])
def test_engine_canvas_counts_and_stages(tiny_engine, gt_lengths):
    texts = ["hi", "hello there", "tiny tts!"]
    with recording() as log:
        waves = tiny_engine.synthesize(texts, "p", seed=1, gt_lengths=gt_lengths)
    frames = [len(w) // tiny_engine.hop_length for w in waves]
    if gt_lengths is not None:
        assert frames == gt_lengths
    nbytes = [len(t.encode()) for t in texts]
    lt = -(-max(nbytes) // 8) * 8  # the text bucket
    (call,) = log.named("engine.synthesize")
    assert call.counts == {"t2s_positions": 4 * (lt + 4 + 16),  # the batch bucket is 4
                           "t2s_used": sum(4 + n + f for n, f in zip(nbytes, frames))}
    stages = [s for s in log.spans if s.parent == call.id]
    assert [s.name for s in stages] == ["engine.t2s", "engine.s2a", "engine.decode"]
    assert call.start <= stages[0].start and stages[-1].end <= call.end
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))


def test_trainer_step_holds_its_phases(tmp_path):
    torch.manual_seed(0)
    model = InjectionConformer(S2AConfig.from_dict(S2A))
    _, loss_fn = s2a_loss(model, bf16=False)
    args = TrainingArguments(output_dir=str(tmp_path), per_device_train_batch_size=4,
                             micro_batches=2, warmup_steps=1, max_steps=10)
    trainer = Trainer(args, model, loss_fn, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"acoustic_tokens": rng.integers(0, 16, (4, 4, 12)),
             "semantic_tokens": rng.integers(0, 8, (4, 12))}
    with recording() as log:
        trainer.train_step(batch, 5)
    (step,) = log.named("train.step")
    inside = [s for s in log.spans if s.parent == step.id]
    assert [s.name for s in inside] == [
        "train.forward", "train.backward", "train.forward", "train.backward", "train.reduce",
        "train.optimizer"]
    assert all(not s.counts for s in log.spans)
    assert all(step.start <= s.start <= s.end <= step.end for s in inside)
    assert len(log.spans) == 7
