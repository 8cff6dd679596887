"""``portbench.spans``: the anchor's mapping of the device's idle intervals
onto the host clock, each reading on a hand-built run, and the tool over
the tiny cells on the CPU."""

from __future__ import annotations

import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, spans
from portbench.tests import tiny
from portbench.trace import Slice
from portbench.traffic import offline_batches, open_loop, train_steps


def _event(name, start_us, end_us, device=DeviceType.CUDA, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start_us, end=end_us))


def _span(sid, name, start, end, parent=None, requests=(), **counts):
    from edm_tts_tpu_torch.utils.profiling import Span

    return Span(sid, name, 1, start, end, parent, tuple(requests), counts)


def test_the_anchor_maps_known_intervals_onto_the_host_clock():
    # the anchor range's middle (1001 us on the profile) is 50.0 s on the host
    events = [_event(spans.ANCHOR, 1000.0, 1002.0, device=DeviceType.CPU),
              _event("k1", 1101.0, 1301.0), _event("k2", 1251.0, 1501.0),
              _event("k3", 2001.0, 2101.0),
              _event("engine.t2s", 900.0, 3000.0, annotation=True),  # a span's device copy
              _event("aten::mm", 1500.0, 2500.0, device=DeviceType.CPU)]
    idle = spans.idle_on_host(events, 50.0, 50.0, 50.0015)
    want = [(50.0, 50.0001), (50.0005, 50.001), (50.0011, 50.0015)]
    assert len(idle) == len(want)
    for (a, b), (c, d) in zip(idle, want):
        assert a == pytest.approx(c, abs=1e-9) and b == pytest.approx(d, abs=1e-9)
    assert spans.idle_on_host(events[:1], 50.0, 49.0, 51.0) == [(49.0, 51.0)]


def _read(run, items) -> dict:
    """Every span metric's reading of ``run`` with ``items`` as its spans,
    by its own file."""
    run.extra.update(spans=items, spans_dropped=0)
    return {m["name"]: harness.metric_module(m["name"]).read(run) for m in spans.METRICS}


def test_the_readings_of_a_hand_built_open_loop_run():
    run = harness.Run("cell", 1, t_open=10.0, t_close=20.0)
    run.requests = [{"due": 10.0 + i, "traced": i >= 8} for i in range(10)]
    run.calls = [{"start": 11.0, "end": 12.0}, {"start": 18.5, "end": 19.5, "traced": True}]
    queued = [_span(i + 1, "batcher.queued", 10.0 + i, 10.1 + i + 0.01 * i, requests=(i,))
              for i in range(10)]
    # held spans are joined to their requests by id, not by time
    held = [_span(i + 20, "batcher.held", 10.2 + i, 10.3 + i + (0.5 if i == 9 else 0.0),
                  requests=(9 - i,)) for i in range(10)]
    collect = [_span(40, "batcher.collect", 17.0, 18.0), _span(41, "batcher.collect", 19.5, 19.8)]
    work = [_span(45, "batcher.call", 10.9, 12.1, requests=(0, 1, 2)),
            _span(46, "batcher.call", 18.4, 19.6, requests=(3, 4, 5, 6, 7, 8, 9)),
            _span(50, "engine.synthesize", 11.0, 12.0, parent=45, t2s_positions=400,
                  t2s_used=100),
            _span(51, "engine.t2s", 11.0, 11.5, parent=50),
            _span(52, "engine.synthesize", 18.5, 19.5, parent=46, t2s_positions=400,
                  t2s_used=300),
            _span(53, "engine.t2s", 18.5, 19.4, parent=52)]
    run.trace = Slice(window_s=2.0, busy_s=1.0, kernels={}, launches=0, gaps=[])
    run.trace.idle, run.trace.t0 = [(17.5, 17.8), (19.6, 19.9)], 17.5
    items = queued + held + collect + work
    got = _read(run, items)
    # requests submitted before the first traced one was due (18.0): 0-7
    assert got["queued_p95_s.open"] == pytest.approx(0.1 + 0.07)
    assert got["held_p95_s.open"] == pytest.approx(0.6)  # request 0's, the tenth held span
    assert got["collect_idle_share.open"] == pytest.approx(100 * (0.3 + 0.2) / 2.0)
    assert got["t2s_s_per_call.serve"] == pytest.approx(0.5)  # the traced call's left out
    assert got["t2s_canvas_use.serve"] == pytest.approx(25.0)
    assert got["optimizer_s_per_step.train"] is None and got["optimizer_idle_share.train"] is None
    extra = spans.readings(run)
    assert extra["rows_per_call"] == 3 and extra["requests_not_in_one_call"] == 0
    assert extra["stage_means"] == pytest.approx({"engine.synthesize": 1.0, "engine.t2s": 0.5})
    assert extra["idle_by_span"]["batcher.collect"] == pytest.approx(25.0)
    assert extra["idle_by_span"]["no span"] == pytest.approx(100 * 0.1 / 2.0)
    assert extra["idle_gaps_by_span"][0] == ["batcher.collect", pytest.approx(0.3), 0.0]
    run.extra["spans"] = items + [_span(47, "batcher.call", 19.7, 19.8, requests=(2,))]
    assert spans.readings(run)["requests_not_in_one_call"] == 1
    run.trace.busy_s = 0.0  # the profile holds no device operation
    got = _read(run, items)
    assert got["collect_idle_share.open"] is None and got["t2s_canvas_use.serve"] == 25.0
    extra = spans.readings(run)
    assert extra["device_trace"] == "empty" and "idle_by_span" not in extra
    run.extra.clear()  # a run that recorded no spans: every reader reads nothing
    assert {m["name"]: harness.metric_module(m["name"]).read(run)
            for m in spans.METRICS} == dict.fromkeys(got)


def test_the_readings_of_a_hand_built_training_run():
    run = harness.Run("cell", 1, t_open=0.0, t_close=3.0)
    run.calls = [{"start": 0.0, "end": 1.0}, {"start": 1.0, "end": 2.0, "traced": True},
                 {"start": 2.0, "end": 3.0}]
    log = []
    for i, t in enumerate((0.0, 1.0, 2.0)):
        base = 10 * (i + 1)
        log += [_span(base, "train.step", t + 0.01, t + 0.99),
                _span(base + 1, "train.forward", t + 0.02, t + 0.3, parent=base),
                _span(base + 2, "train.backward", t + 0.3, t + 0.7, parent=base),
                _span(base + 3, "train.reduce", t + 0.7, t + 0.72, parent=base),
                _span(base + 4, "train.optimizer", t + 0.72, t + 0.72 + 0.1 * (i + 1),
                      parent=base)]
    # an optimizer span of no step is no step's
    log.append(_span(99, "train.optimizer", 2.5, 2.9))
    run.trace = Slice(window_s=1.0, busy_s=0.5, kernels={}, launches=0, gaps=[])
    run.trace.idle, run.trace.t0 = [(1.0, 1.01), (1.75, 1.85)], 1.0
    got = _read(run, log)
    assert got["optimizer_s_per_step.train"] == pytest.approx((0.1 + 0.3) / 2)
    assert got["optimizer_idle_share.train"] == pytest.approx(100 * 0.1 / 1.0)
    assert got["queued_p95_s.open"] is None and got["t2s_canvas_use.serve"] is None
    extra = spans.readings(run)
    assert extra["stage_means"]["train.backward"] == pytest.approx(0.4)
    assert extra["idle_by_span"] == pytest.approx({"train.optimizer": 10.0, "no span": 1.0})


@pytest.mark.parametrize("kind,spec,cfg,seconds", [
    (offline_batches, tiny.OFFLINE, tiny.SERVE_CONFIG, 0.0),
    (train_steps, tiny.TRAIN, tiny.TRAIN_CONFIG, 0.0),
    (open_loop, tiny.OPEN, tiny.SERVE_CONFIG, 1.0)])
def test_the_tool_over_a_tiny_traced_cell(kind, spec, cfg, seconds):
    torch.set_num_threads(2)
    run = spans.run_recorded(kind, tiny.context(spec, cfg, traced=True, seconds=seconds))
    assert kind.Tracer is spans.Tracer  # put back
    assert run.checks and all(c.ok for c in run.checks)
    assert run.trace.idle == [(run.trace.t0, run.trace.t0 + run.trace.window_s)]
    got = spans.readings(run)
    assert got["dropped"] == 0 and got["device_trace"] == "empty"  # no card, no device trace
    assert "collect_idle_share.open" not in got and "optimizer_idle_share.train" not in got
    if kind is train_steps:
        assert got["optimizer_s_per_step.train"] > 0
    if kind is offline_batches:  # the engine's count against the cell's own texts
        assert 0 < got["t2s_canvas_use.serve"] <= 100 and got["t2s_s_per_call.serve"] > 0
        assert spans.canvas_closed_form(run, spec, cfg, run.seed) == pytest.approx(
            got["t2s_canvas_use.serve"], rel=1e-12)
    if kind is open_loop:  # which calls start before the slice depends on the host's pace
        names = [s.name for s in run.extra["spans"]]
        assert {"batcher.queued", "batcher.held", "batcher.collect", "batcher.call",
                "engine.synthesize", "engine.t2s"} <= set(names)
        assert names.count("batcher.queued") == names.count("batcher.held") >= run.attempted
        assert got["requests_not_in_one_call"] == 0
