"""The traffic generators: the open loop's due times and sizes, the
offline batches' texts, and the tail and rate arithmetic of the metrics."""

from __future__ import annotations

import math

import pytest

from portbench import harness
from portbench.traffic import offline_batches, open_loop

MIX = {"rate": 10.0, "speech_s": {"median": 4.0, "sigma": 0.6, "min": 1.0, "max": 20.0},
       "bytes_per_s": 15, "bytes_jitter": 0.2, "lead_s": 4.0}


def test_open_loop_schedule_is_the_same_work_in_another_order():
    a = open_loop.schedule(MIX, 1, 30.0, 50.0)
    b = open_loop.schedule(MIX, 2**31 + 12345, 30.0, 50.0)
    assert [r["text"] for r in a] != [r["text"] for r in b]
    # the same sizes and gaps, shuffled: equal up to the last arrivals the
    # window's end cuts off
    n = min(len(a), len(b))
    assert abs(len(a) - len(b)) <= 0.05 * n
    sa, sb = sorted(r["frames"] for r in a), sorted(r["frames"] for r in b)
    assert abs(sum(sa) - sum(sb)) <= 0.05 * sum(sa)
    for sched in (a, b):
        dues = [r["due"] for r in sched]
        assert dues == sorted(dues) and 0 < dues[0] and dues[-1] < 34.0
        assert all(50 <= r["frames"] <= 1000 for r in sched)
        assert len({r["text"] for r in sched}) == len(sched)
        assert abs(len(sched) - 340) <= 20
        for r in sched:
            assert abs(len(r["text"].encode()) - 15 * r["frames"] / 50) <= 0.2 * 15 * r["frames"] / 50 + 1


def test_open_loop_speech_lengths_follow_the_lognormal():
    s = open_loop.schedule({**MIX, "rate": 100.0}, 3, 96.0, 50.0)
    frames = sorted(r["frames"] for r in s)
    assert abs(frames[len(frames) // 2] - 200) <= 5  # median 4 s
    assert frames[0] >= 50 and frames[-1] <= 1000


def test_offline_texts_are_a_fixed_set_of_sizes():
    spec = {"rows": 16, "text_bytes": [80, 200]}
    for seed in (1, 2**31 + 7):
        sizes = sorted(len(t.encode()) for t in offline_batches._texts(spec, seed, 3))
        assert sizes == list(range(80, 201, 8))
    assert offline_batches._texts(spec, 1, 3) != offline_batches._texts(spec, 1, 4)


def _run(requests, calls=(), window=(0.0, 10.0)):
    run = harness.Run("c", 0)
    run.t_open, run.t_close = window
    run.requests, run.calls = list(requests), list(calls)
    return run


def test_latency_is_taken_from_the_due_time_and_counts_failures():
    p95 = harness.metric_module("latency_p95_s").read
    wait = harness.metric_module("queue_wait_p95_s.open").read
    reqs = [{"due": i * 0.1, "start": i * 0.1 + 0.05, "done": i * 0.1 + 1.0, "audio_s": 1.0}
            for i in range(100)]
    assert p95(_run(reqs)) == pytest.approx(1.0)
    assert wait(_run(reqs)) == pytest.approx(0.05)
    # a stall: the requests due in it start late, and so finish late
    stalled = [dict(r, start=max(r["start"], 5.0), done=max(r["done"], 6.0)) for r in reqs]
    assert p95(_run(stalled)) > 1.5 and wait(_run(stalled)) > 1.0
    failed = [dict(r, done=None) if i % 10 == 0 else r for i, r in enumerate(reqs)]
    assert p95(_run(failed)) == math.inf


def test_rates_cover_all_the_work_and_all_the_window():
    rate = harness.metric_module("audio_s_per_s").read
    reqs = [{"due": 0.0, "start": 0.0, "done": 1.0, "audio_s": 2.0}] * 10
    run = _run(reqs, window=(0.0, 4.0))
    assert rate(run) == pytest.approx(5.0)
    run.t_close = 8.0  # the same work over a longer window
    assert rate(run) == pytest.approx(2.5)
    tokens = harness.metric_module("train_tokens_per_s").read
    run = _run([], calls=[{"tokens": 100, "start": 0, "end": 1}] * 6, window=(0.0, 3.0))
    assert tokens(run) == pytest.approx(200.0)
