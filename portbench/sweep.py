"""Find the highest rate an open-loop cell's stack sustains: a sweep of
fixed rates on the card, one process, the engine built once.

    python3 -m portbench.sweep --workload serve_open_poisson --seed 7 \\
        --rates 8,10,12 --repeats 3 --seconds 51

Each rate runs ``--repeats`` times (seeds ``--seed``, ``--seed`` + 1, ...:
the same sizes and gaps in other orders), each time the cell's mix at
that rate (``lead_s`` of lead, then ``--seconds``). After each window
(waiting at most ``drain_s`` for its requests) the line reports the
requests due, the waiting backlog (submitted, not yet in an engine call)
sampled every 0.1 s of the window, and the 95th percentile latency of
the requests due in the window's first and second half (one not back
counts as infinitely late). A repeat passes where

- the backlog does not grow: the mean waiting backlog over the second
  half is at most 1.25 x that over the first half, plus one request;
- the tail does not climb: the second half's 95th percentile is at most
  1.25 x the first half's.

A rate is sustained where every repeat passes. The waiting backlog's
maximum is reported and not judged: Poisson bursts take it past one batch
(16) at 8/s as at 12/s on an H100, where its mean is 3-5 requests. Not part of a benchmark
run: the cell's file records 0.8 x the highest sustained rate as its
``rate``.
"""

from __future__ import annotations

import argparse
import math
import statistics
import threading
import time

import torch


def main(argv=None) -> int:
    from portbench import harness, serving
    from portbench.reference import model as ref

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests per second")
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: needs a CUDA device")
        return 2
    spec = harness.cell(args.workload)
    cfg = harness.config(spec["config"])
    served = serving.build(cfg, args.seed, torch.device("cuda", 0))
    frame_rate = cfg["codec"]["sample_rate"] / ref.hop(cfg["codec"])
    verdicts = {}
    for rate in (float(r) for r in args.rates.split(",")):
        for rep in range(args.repeats):
            ok = window_once(served, {**spec["traffic"], "rate": rate}, args.seed + rep,
                             args.seconds, frame_rate)
            verdicts.setdefault(rate, []).append(ok)
    sustained = [r for r, oks in verdicts.items() if all(oks)]
    print(f"sustained (every repeat passes): {sustained}; the highest: "
          f"{max(sustained) if sustained else None}", flush=True)
    return 0


def p95(values: list) -> float:
    values = sorted(values)
    return values[max(0, math.ceil(0.95 * len(values)) - 1)] if values else math.nan


def window_once(served, mix: dict, seed: int, seconds: float, frame_rate: float) -> bool:
    from portbench.traffic import open_loop

    driver = open_loop.Driver(served, mix, set())
    driver.warm_up()
    requests = open_loop.schedule(mix, seed, seconds, frame_rate)
    lead = mix["lead_s"]
    window = [r for r in requests if r["due"] >= lead]
    t0 = time.perf_counter()
    gen = threading.Thread(target=driver.generate, args=(requests, t0, []), daemon=True)
    gen.start()
    gen.join()
    deadline = t0 + lead + seconds + mix["drain_s"]
    for r in window:
        if "future" in r:
            try:
                r["future"].result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # noqa: BLE001 — counted as infinitely late
                pass
    driver.batcher.close(drain=True)  # the next window starts on an idle engine

    def waiting(at: float) -> int:
        return sum(1 for r in requests if r.get("submitted", math.inf) <= at
                   < driver.started.get(r["text"], math.inf))

    samples = [waiting(t0 + lead + k / 10) for k in range(int(seconds * 10))]
    half = len(samples) // 2
    first, second = samples[:half], samples[half:]
    lat = {id(r): (r["done"] - (t0 + r["due"]) if "done" in r else math.inf) for r in window}
    mid = lead + seconds / 2
    p_first = p95([lat[id(r)] for r in window if r["due"] < mid])
    p_second = p95([lat[id(r)] for r in window if r["due"] >= mid])
    m_first, m_second = statistics.mean(first), statistics.mean(second)
    calls = [c for c in driver.calls if t0 + lead <= c["start"] < t0 + lead + seconds]
    ok = m_second <= 1.25 * m_first + 1 and p_second <= 1.25 * p_first
    print(f"rate {mix['rate']} seed {seed}: due {len(window)}, waiting backlog max "
          f"{max(samples)} mean {m_first:.2f} / {m_second:.2f} (halves), latency p95 "
          f"{p_first:.3f} / {p_second:.3f} s (halves), p95 all {p95(list(lat.values())):.3f} s, "
          f"calls {len(calls)}, rows per call "
          f"{sum(c['rows'] for c in calls) / max(1, len(calls)):.2f}: "
          f"{'passes' if ok else 'fails'}", flush=True)
    return ok


if __name__ == "__main__":
    raise SystemExit(main())
