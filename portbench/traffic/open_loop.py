"""Open loop: independent users' requests arrive on a schedule into the
port's ``DynamicBatcher.submit`` in front of ``TTSEngine.synthesize``,
whether or not earlier ones are done.

Parameters (the cell's ``traffic``): ``rate`` requests a second, Poisson
arrivals; each request's speech length (``gt_length``) lognormal with
``speech_s.median`` and ``speech_s.sigma``, clipped to ``speech_s.min`` -
``speech_s.max`` seconds; its text about ``bytes_per_s`` bytes a second of
speech, +-``bytes_jitter``, random words from the seed (unique, so texts
map to requests); one speaker and the sampling seed ``request_seed`` for
all; ``batcher`` the batcher's options. The sizes and the gaps between
arrivals are the same set in every run (evenly spaced quantiles of their
distributions) in an order drawn from the seed, so a seed changes the
order and the words and not the work.

The generator starts ``lead_s`` before the window, so the window opens on
a loaded queue; it submits every request due before the window closes.
Each request is timed from when it was due. A traced run profiles
``trace.seconds`` from ``trace.start_s`` into the window; the requests due
and the calls started from ``trace.settle_s`` before that slice on are
marked traced, and the batcher's per-layer metrics leave them out (the
profiler slows the host, and its stop holds the interpreter for a few
seconds). After the close the run waits
(up to ``drain_s``) for every request due in the window; one that failed,
was refused or never came counts as infinitely late. The benchmark's
wrapper around the ``synth_fn`` it hands the batcher times each engine
call and has the recorder keep the stages of the calls that carry a
request of the sample (the longest due in the window and ``check.requests``
more drawn from the seed); ``check_serve`` judges every row of those calls
after the window, ``check.rows_per_block`` rows at a time.
"""

from __future__ import annotations

import math
import queue
import random
import statistics
import threading
import time

from portbench import serving, weights
from portbench.harness import Context, Run
from portbench.reference import model as ref
from portbench.trace import Tracer


def schedule(mix: dict, seed: int, seconds: float, frame_rate: float) -> list[dict]:
    """The requests due from the generator's start through the window's
    close: ``due`` (seconds after the start), ``frames`` and ``text``."""
    total = mix["lead_s"] + seconds
    n = max(1, round(mix["rate"] * total))
    dist = statistics.NormalDist(math.log(mix["speech_s"]["median"]), mix["speech_s"]["sigma"])
    lo, hi = mix["speech_s"]["min"], mix["speech_s"]["max"]
    speech = [min(hi, max(lo, math.exp(dist.inv_cdf((i + 0.5) / n)))) for i in range(n)]
    gaps = [-math.log(1.0 - (i + 0.5) / n) / mix["rate"] for i in range(n)]
    rng = random.Random(weights.mix(seed, 20))
    rng.shuffle(speech)
    rng.shuffle(gaps)
    out, due, seen = [], 0.0, set()
    for s, g in zip(speech, gaps):
        due += g
        if due >= total:
            break
        size = max(2, round(s * mix["bytes_per_s"] * (1 + mix["bytes_jitter"] * rng.uniform(-1, 1))))
        text = serving.random_text(rng, size)
        while text in seen:
            text = serving.random_text(rng, size)
        seen.add(text)
        out.append({"due": due, "frames": max(1, round(s * frame_rate)), "text": text})
    return out


class Driver:
    """The batcher over the engine, the timing wrapper and the generator."""

    def __init__(self, served: serving.Served, mix: dict, sampled: set):
        from edm_tts_tpu_torch.serving import DynamicBatcher

        self.served, self.mix, self.sampled = served, mix, sampled
        self.calls: list[dict] = []
        self.started: dict[str, float] = {}
        self.kept: list = []
        b = mix["batcher"]
        self.batcher = DynamicBatcher(self.synth, max_batch=b["max_batch"],
                                      max_wait_ms=b["max_wait_ms"], lookahead=b["lookahead"],
                                      max_queue=b["max_queue"])

    def synth(self, texts, speaker, seed=0, gt_lengths=None):
        rec = self.served.recorder
        cap = {} if any(t in self.sampled for t in texts) else None
        rec.capture = cap
        t0 = time.perf_counter()
        try:
            waves = self.served.engine.synthesize(texts, speaker, seed=seed, gt_lengths=gt_lengths)
        finally:
            rec.capture = None
        self.calls.append({"start": t0, "end": time.perf_counter(), "rows": len(texts)})
        for t in texts:
            self.started[t] = t0
        if cap is not None:
            self.kept.append((cap, list(texts), gt_lengths, waves, seed))
        return waves

    def generate(self, requests: list[dict], t_start: float, late: list) -> None:
        """Submit each request at its due time (run on its own thread)."""
        from edm_tts_tpu_torch.serving.batcher import Request

        for r in requests:
            wait = t_start + r["due"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            r["submitted"] = time.perf_counter()
            late.append(r["submitted"] - t_start - r["due"])
            try:
                r["future"] = self.batcher.submit(Request(r["text"], "spk",
                                                          seed=self.mix["request_seed"],
                                                          gt_length=r["frames"]))
                r["future"].add_done_callback(lambda f, r=r: r.__setitem__(
                    "done", time.perf_counter()))
            except queue.Full:
                r["refused"] = True

    def warm_up(self) -> list[str]:
        """One call at each batch bucket, at the median length; returns the
        calls that failed (the window's calls at those shapes fail too and
        are counted there)."""
        med = round(self.mix["speech_s"]["median"] * self.served.engine.sample_rate
                    / self.served.engine.hop_length)
        rng = random.Random(1)
        failed = []
        for b in self.served.engine.batch_buckets:
            texts = [serving.random_text(rng, 60) for _ in range(b)]
            try:
                self.served.engine.synthesize(texts, "spk", seed=self.mix["request_seed"],
                                              gt_lengths=[med] * b)
            except Exception as e:  # noqa: BLE001 — a failed call is counted, not fatal
                failed.append(f"batch {b}: {e!r}"[:300])
        return failed


def run(ctx: Context) -> Run:
    mix, cfg = ctx.spec["traffic"], ctx.config
    served = serving.build(cfg, ctx.seed, ctx.device, control=ctx.control == "precision")
    codec = cfg["codec"]
    frame_rate = codec["sample_rate"] / ref.hop(codec)
    requests = schedule(mix, ctx.seed, ctx.seconds, frame_rate)
    lead = mix["lead_s"]
    window = [r for r in requests if r["due"] >= lead]
    chk = ctx.spec["check"]
    rng = random.Random(weights.mix(ctx.seed, 21))
    longest = max(window, key=lambda r: r["frames"])
    others = [r for r in window if r is not longest]
    sampled = {longest["text"]} | {r["text"] for r in rng.sample(others, min(len(others),
                                                                            chk["requests"]))}
    driver = Driver(served, mix, sampled)
    warm_failures = driver.warm_up()
    late: list = []
    tracer = Tracer() if ctx.traced else None
    # the slice sits inside the window, however short the window is
    tr = dict(ctx.spec["trace"])
    tr["start_s"] = max(0.0, min(tr["start_s"], ctx.seconds - tr["seconds"]))
    t_gen = time.perf_counter()
    gen = threading.Thread(target=driver.generate, args=(requests, t_gen, late), daemon=True)
    gen.start()
    run = ctx.new_run()
    run.t_open = t_gen + lead
    run.setup_s = run.t_open - ctx.t_start
    if tracer is not None:
        time.sleep(max(0.0, run.t_open + tr["start_s"] - time.perf_counter()))
        n0 = len(driver.calls)
        served.recorder.spans = True
        tracer.start()
        time.sleep(tr["seconds"])
        tracer.stop(0)
        served.recorder.spans = False
        tracer.units = max(1, len(driver.calls) - n0)
    gen.join()
    run.t_close = run.t_open + ctx.seconds
    deadline = time.perf_counter() + mix["drain_s"]
    for r in window:
        fut = r.get("future")
        if fut is None:
            continue
        try:
            fut.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noqa: BLE001 — a failed or late request is counted below
            pass
    driver.batcher.close(drain=False)
    run.trace = tracer.result() if tracer is not None else None
    # the profile's slice and what it holds up: the batcher's per-layer
    # metrics read the requests due, and the calls started, before it
    cut = run.t_open + tr["start_s"] - tr["settle_s"] if tracer is not None else math.inf
    for r in window:
        fut = r.get("future")
        ok = fut is not None and fut.done() and fut.exception() is None and "done" in r
        run.attempted += 1
        run.failed += 0 if ok else 1
        run.requests.append({"due": t_gen + r["due"], "start": driver.started.get(r["text"]),
                             "traced": t_gen + r["due"] >= cut,
                             "done": r["done"] if ok else None,
                             "audio_s": r["frames"] / frame_rate})
    run.calls = [dict(c, traced=c["start"] >= cut) for c in driver.calls
                 if run.t_open <= c["start"] < run.t_close]
    if warm_failures:
        run.notes["warm-up calls that failed"] = warm_failures
    late_window = sorted(late[len(requests) - len(window):]) or [0.0]
    run.notes["generator lateness (s): median, max"] = (statistics.median(late_window),
                                                       late_window[-1])
    run.notes["requests due in the window"] = len(window)
    run.notes["requests refused"] = sum(1 for r in window if r.get("refused"))
    missing = sum(1 for r in window if r["text"] in sampled and r.get("done") is None)
    kept = driver.kept
    driver.batcher = driver.served = None
    serving.judge(ctx, run, served, kept, missing)
    return run
