"""The port's own spans in a run of a cell, and a tool that reads them.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell as ``portbench.run`` does and prints its result line, with
the program's span recording (``edm_tts_tpu_torch.utils.profiling.
recording``) on from the traffic kind's start to its end, the log in
``run.extra["spans"]``, and with ``--trace 1`` an anchor in the profile
(``AnchoredTracer``) that puts the device's idle intervals on the host
clock the spans use (``run.trace.idle``). A last line gives, as JSON, the
span metrics of ``METRICS`` (each ``metrics/<name>.py``, read by
``harness.read_metrics``) and what the tool adds: each engine stage's and
trainer phase's mean seconds, rows per call and whether every request id
is in exactly one ``batcher.call``, the idle by innermost span, and for the
offline cell the canvas use's closed form from its own texts. With
``--trace 0`` the run's end-to-end metrics show what recording costs
against ``portbench.run`` at the same seed.

No entry of ``BENCHMARK.json`` names these metrics, and no traffic kind
records spans, so a benchmark run reads none of them. The helpers below
are what the metric files share: each leaves out what the traced slice
holds up by the rule of the cell's existing metrics (a call's spans when
the call is traced, a request's when it was submitted at or after the
first traced request's due time).
"""

from __future__ import annotations

import bisect
import json
import math
import sys
import time
import types

import torch

from portbench.trace import Tracer, _union

ANCHOR = "portbench.anchor"
# the span metrics: what ``harness.read_metrics`` needs of their entries
METRICS = [{"name": "queued_p95_s.open", "unit": "s"}, {"name": "held_p95_s.open", "unit": "s"},
           {"name": "collect_idle_share.open", "unit": "%"},
           {"name": "t2s_s_per_call.serve", "unit": "s"},
           {"name": "t2s_canvas_use.serve", "unit": "%"},
           {"name": "optimizer_s_per_step.train", "unit": "s"},
           {"name": "optimizer_idle_share.train", "unit": "%"}]


class AnchoredTracer(Tracer):
    """``Tracer`` with one anchor: a ``record_function`` range opened at a
    ``perf_counter`` time it keeps. Its slice also holds ``idle``: the
    device's idle intervals inside the slice on the host clock, and ``t0``,
    the slice's start there."""

    def start(self) -> None:
        super().start()
        t0 = time.perf_counter()
        with torch.profiler.record_function(ANCHOR):
            pass
        self.anchor = 0.5 * (t0 + time.perf_counter())

    def result(self):
        if self._slice is None:
            idle = idle_on_host(self.prof.events(), self.anchor, self.t0,
                                self.t0 + self.window_s)
            piece = super().result()
            piece.idle, piece.t0 = idle, self.t0
        return self._slice


def idle_on_host(events, anchor: float, lo: float, hi: float) -> list[tuple[float, float]]:
    """The device's idle intervals in ``[lo, hi]`` (host seconds): the
    complement of the union of its operations, moved onto the host clock by
    the anchor range (whose middle is at ``anchor``)."""
    from torch.autograd import DeviceType

    mark = next(e for e in events if e.name == ANCHOR and e.device_type != DeviceType.CUDA)
    shift = anchor - 0.5e-6 * (mark.time_range.start + mark.time_range.end)
    busy = [(e.time_range.start * 1e-6 + shift, e.time_range.end * 1e-6 + shift)
            for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    idle, at = [], lo
    for a, b in _union(busy)[1]:
        if a > at:
            idle.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        idle.append((at, hi))
    return [(a, b) for a, b in idle if b > a]


def run_recorded(kind, ctx):
    """``kind.run(ctx)`` with spans recorded into ``run.extra["spans"]``
    (and the spans the log could not hold in ``["spans_dropped"]``) and
    ``AnchoredTracer`` in the kind's ``Tracer``'s place."""
    from edm_tts_tpu_torch.utils.profiling import recording

    saved = kind.Tracer
    kind.Tracer = AnchoredTracer
    try:
        with recording() as log:
            run = kind.run(ctx)
    finally:
        kind.Tracer = saved
    run.extra["spans"], run.extra["spans_dropped"] = log.spans, log.dropped
    return run


# -- what the metric files share ------------------------------------------

def named(run, name: str) -> list | None:
    """The run's spans called ``name``; None where the run recorded none."""
    log = run.extra.get("spans")
    return None if log is None else [s for s in log if s.name == name]


def untraced(run, spans) -> list:
    """The spans that start inside an untraced call or step of the run."""
    calls = sorted((c["start"], c["end"]) for c in run.untraced_calls())
    starts = [a for a, _ in calls]
    out = []
    for s in spans:
        i = bisect.bisect_right(starts, s.start) - 1
        if i >= 0 and s.start <= calls[i][1]:
            out.append(s)
    return out


def inside(run, name: str, parent: str) -> tuple[list, list] | None:
    """(the untraced ``parent`` spans, the ``name`` spans whose parent is
    one of them); None where the run recorded no spans."""
    parents, children = named(run, parent), named(run, name)
    if parents is None:
        return None
    ids = {p.id for p in untraced(run, parents)}
    return [p for p in parents if p.id in ids], [s for s in children if s.parent in ids]


def request_phase(run, name: str) -> list | None:
    """A request phase's spans (``batcher.queued`` or ``batcher.held``),
    joined by request id to the requests submitted in the window before the
    first traced request was due."""
    queued = named(run, "batcher.queued")
    if not queued:
        return None
    due = [r["due"] for r in run.requests if r.get("traced")]
    cut = min([run.t_close] + due)
    ids = {s.requests[0] for s in queued if run.t_open <= s.start < cut}
    return [s for s in named(run, name) if s.requests[0] in ids]


def idle_share(run, name: str) -> float | None:
    """The share of the traced slice (%) in which the device is idle while
    the host is inside a ``name`` span; None without spans or without a
    device operation in the slice."""
    spans = named(run, name)
    trace = run.trace
    if not spans or trace is None or not trace.busy_s or getattr(trace, "idle", None) is None:
        return None
    return 100.0 * _overlap(trace.idle, spans) / trace.window_s


def p95(values: list[float]) -> float:
    """The 95th percentile, nearest rank."""
    values = sorted(values)
    return values[max(0, math.ceil(0.95 * len(values)) - 1)]


def _overlap(intervals: list[tuple[float, float]], spans) -> float:
    """Seconds of ``intervals`` inside the union of ``spans``."""
    _, merged = _union([(s.start, s.end) for s in spans])
    starts = [a for a, _ in merged]
    total = 0.0
    for a, b in intervals:
        for c, d in merged[max(0, bisect.bisect_right(starts, a) - 1):]:
            if c >= b:
                break
            total += max(0.0, min(b, d) - max(a, c))
    return total


# -- what the tool adds ----------------------------------------------------

def stage_means(run) -> dict:
    """Mean seconds a call of each engine stage and a step of each trainer
    phase, over the untraced calls and steps."""
    out = {}
    for parent, stages in (("engine.synthesize", ("engine.t2s", "engine.s2a", "engine.decode")),
                           ("train.step", ("train.forward", "train.backward", "train.reduce",
                                           "train.optimizer"))):
        for stage in stages:
            parents, spans = inside(run, stage, parent)
            if spans:
                out[parent] = sum(p.end - p.start for p in parents) / len(parents)
                out[stage] = sum(s.end - s.start for s in spans) / len(parents)
    return out


def calls_and_requests(run) -> dict:
    """Rows per untraced ``batcher.call`` (the calls whose engine call is
    untraced), and how many request ids are not in exactly one call."""
    calls = named(run, "batcher.call")
    if not calls:
        return {}
    engine = {s.parent for s in untraced(run, named(run, "engine.synthesize"))}
    rows = [len(c.requests) for c in calls if c.id in engine]
    owners: dict[int, int] = {}
    for c in calls:
        for rid in c.requests:
            owners[rid] = owners.get(rid, 0) + 1
    strays = sum(1 for s in named(run, "batcher.queued") if owners.get(s.requests[0]) != 1)
    return {"rows_per_call": sum(rows) / len(rows) if rows else None,
            "requests_not_in_one_call": strays}


def idle_by_span(run) -> tuple[dict, list]:
    """The traced slice's idle time by the innermost span (a request's
    phases left out) in flight: ({name: share of the slice in %}, the ten
    longest idle intervals as [name, seconds, seconds from the slice's
    start]); "no span" where none is."""
    idle, t0 = run.trace.idle, run.trace.t0
    lo, hi = (idle[0][0], idle[-1][1]) if idle else (0.0, 0.0)
    work = [s for s in run.extra["spans"] if s.name not in ("batcher.queued", "batcher.held")
            and s.end > lo and s.start < hi]
    bounds = sorted({t for s in work for t in (s.start, s.end)})

    def innermost(t):
        held = [s for s in work if s.start <= t <= s.end]
        return min(held, key=lambda s: s.end - s.start).name if held else "no span"

    shares: dict[str, float] = {}
    longest = []
    for a, b in idle:
        cuts = [a] + bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)] + [b]
        for c, d in zip(cuts, cuts[1:]):
            name = innermost(0.5 * (c + d))
            shares[name] = shares.get(name, 0.0) + (d - c)
        longest.append([innermost(0.5 * (a + b)), b - a, a - t0])
    window = run.trace.window_s
    return ({k: 100.0 * v / window for k, v in sorted(shares.items(), key=lambda kv: -kv[1])},
            sorted(longest, key=lambda g: -g[1])[:10])


def canvas_closed_form(run, spec: dict, cfg: dict, seed: int) -> float | None:
    """The offline cell's t2s canvas use from its own texts and the audio
    each untraced call returned: over the calls, sum over the rows of 4 +
    text bytes + frames, over rows x (the text bucket + 4 + the canvas)."""
    from portbench.reference import model as ref
    from portbench.traffic import offline_batches

    sv, codec = cfg["serving"], cfg["codec"]
    frames_per_s = codec["sample_rate"] / ref.hop(codec)
    used = positions = 0
    for i, call in enumerate(run.calls):
        if call.get("traced") or not call.get("audio_s"):
            continue
        nbytes = [len(t.encode()) for t in offline_batches._texts(spec["traffic"], seed, i)]
        lt = -(-max(nbytes) // sv["text_bucket"]) * sv["text_bucket"]
        used += 4 * len(nbytes) + sum(nbytes) + round(call["audio_s"] * frames_per_s)
        positions += len(nbytes) * (lt + 4 + sv["max_speech_len"])
    return 100.0 * used / positions if positions else None


def readings(run) -> dict:
    """The span metrics of a recorded run (``METRICS``; those that read
    nothing left out) and what the tool adds."""
    from portbench import harness

    out = {k: v["value"] for k, v in harness.read_metrics(run, METRICS).items()}
    out.update(stage_means=stage_means(run), **calls_and_requests(run),
               spans=len(run.extra["spans"]), dropped=run.extra["spans_dropped"])
    trace = run.trace
    if trace is not None and trace.busy_s and getattr(trace, "idle", None) is not None:
        out["idle_by_span"], out["idle_gaps_by_span"] = idle_by_span(run)
    elif trace is not None:
        out["device_trace"] = "empty"  # on the CPU, or a slice after the work was done
    return out


def main(argv: list[str] | None = None) -> int:
    from portbench import harness
    from portbench import run as bench

    captured = {}
    real = harness.traffic_kind

    def traffic_kind(name):
        kind = real(name)

        def run(ctx):
            captured["run"] = run_recorded(kind, ctx)
            return captured["run"]

        return types.SimpleNamespace(run=run)

    harness.traffic_kind = traffic_kind
    try:
        code = bench.main(argv)
    finally:
        harness.traffic_kind = real
    if code == 0 and "run" in captured:
        run = captured["run"]
        out = readings(run)
        spec = harness.cell(run.cell)
        if spec["traffic"]["kind"] == "offline_batches":
            out["t2s_canvas_use.closed_form"] = canvas_closed_form(
                run, spec, harness.config(spec["config"]), run.seed)
        print(json.dumps({"spans": out}), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
