"""Offline batches: a closed loop of back-to-back ``TTSEngine.synthesize``
calls, as a batch synthesis job or a loaded server's full buckets drive it.

Parameters (the cell's ``traffic``): ``rows`` texts a call, their byte
lengths spread evenly over ``text_bytes`` (the same set in every call and
every seed, in an order drawn from the seed), random words from the seed,
one registered speaker and a new sampling seed a call. Lengths come from
the length predictor.

Set-up: weights, the engine, the prompt, then two calls at the cell's
shapes (the second with the kernel counters read back against the
benchmark's own count of K5's and K1's launches). The window then runs
calls until ``--seconds`` have passed; it closes when the last call
returns. ``check``: the calls whose stages the recorder keeps (``calls``
drawn from the seed among the first ``among``), judged by
``check_serve`` after the window in blocks of ``rows_per_block`` rows.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import arith, serving, weights
from portbench.harness import Context, Run
from portbench.reference import model as ref
from portbench.trace import Tracer


def _texts(spec: dict, seed: int, index: int) -> list[str]:
    rng = random.Random(weights.mix(seed, 1000 + index))
    lo, hi = spec["text_bytes"]
    n = spec["rows"]
    sizes = [round(lo + (hi - lo) * i / max(n - 1, 1)) for i in range(n)]
    rng.shuffle(sizes)
    return [serving.random_text(rng, s) for s in sizes]


def _call_seed(seed: int, index: int) -> int:
    return weights.mix(seed, 5000 + index) & 0x7FFFFFFF


def _buckets(cfg: dict, texts: list[str], waves: list) -> tuple[int, int, int]:
    hop = ref.hop(cfg["codec"])
    return arith.engine_buckets(cfg["serving"], [len(t.encode()) for t in texts],
                                [len(w) // hop for w in waves])


def crosscheck(ctx: Context, cfg: dict, texts: list[str], waves: list) -> None:
    """K5's and K1's launches of the last call against the benchmark's count."""
    from edm_tts_tpu_torch import kernels

    rows, lt, nb = _buckets(cfg, texts, waves)
    want = arith.int8_launches(cfg, rows, lt, nb, predicted=True)
    got = dict(kernels.int8_dense_shapes)
    ctx.say("crosscheck K5 shapes:", "match" if got == dict(want) else f"differ: port {got} "
            f"benchmark {dict(want)}")
    want = arith.resunit_launches(cfg["codec"], rows, nb)
    got = dict(kernels.resunit_shapes)
    ctx.say("crosscheck K1 shapes:", "match" if got == dict(want) else f"differ: port {got} "
            f"benchmark {dict(want)}")


def run(ctx: Context) -> Run:
    spec, cfg = ctx.spec["traffic"], ctx.config
    served = serving.build(cfg, ctx.seed, ctx.device, control=ctx.control == "precision")
    engine, rec = served.engine, served.recorder
    hop, sr = ref.hop(cfg["codec"]), cfg["codec"]["sample_rate"]
    for w in range(2):  # warm-up at the cell's shapes
        if w == 1 and ctx.device.type == "cuda":
            from edm_tts_tpu_torch import kernels
            kernels.reset_launches()
        texts = _texts(spec, ctx.seed, -1 - w)
        waves = engine.synthesize(texts, "spk", seed=_call_seed(ctx.seed, -1 - w))
    if ctx.device.type == "cuda":
        crosscheck(ctx, cfg, texts, waves)
    chk = ctx.spec["check"]
    sample = set(random.Random(weights.mix(ctx.seed, 7)).sample(range(chk["among"]), chk["calls"]))
    tr = ctx.spec["trace"]
    first, last = tr["first"], tr["first"] + tr["count"]
    tracer = Tracer() if ctx.traced else None
    kept = []
    run = ctx.new_run()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    run.t_open = time.perf_counter()
    run.setup_s = run.t_open - ctx.t_start
    i = 0
    while True:
        if tracer is not None and i == first:
            tracer.start()
            rec.spans = True
        texts = _texts(spec, ctx.seed, i)
        cap = {} if i in sample else None
        rec.capture = cap
        t0 = time.perf_counter()
        try:
            waves = engine.synthesize(texts, "spk", seed=_call_seed(ctx.seed, i))
        except Exception as e:  # noqa: BLE001 — a failed call is counted, not fatal
            ctx.say(f"call {i} failed: {e!r}")
            waves = None
        t1 = time.perf_counter()
        rec.capture = None
        traced = tracer is not None and first <= i < last
        if tracer is not None and i == last - 1:
            tracer.stop(tr["count"])
            rec.spans = False
        run.attempted += len(texts)
        call = {"start": t0, "end": t1, "rows": len(texts), "traced": traced, "audio_s": 0.0,
                "flops": 0.0}
        if waves is None:
            run.failed += len(texts)
        else:
            frames = [len(w) // hop for w in waves]
            call["audio_s"] = sum(len(w) for w in waves) / sr
            call["flops"] = sum(arith.request_flops(cfg, len(t.encode()), f, predicted=True)
                                for t, f in zip(texts, frames))
            if traced:
                rows, lt, nb = _buckets(cfg, texts, waves)
                call["int8_least_s"] = arith.int8_least_s(
                    arith.int8_launches(cfg, rows, lt, nb, predicted=True))
                call["resunit_least_s"] = arith.resunit_least_s(
                    arith.resunit_launches(cfg["codec"], rows, nb))
        for _ in range(len(texts)):
            run.requests.append({"due": t0, "start": t0, "done": t1 if waves else None,
                                 "audio_s": call["audio_s"] / len(texts)})
        run.calls.append(call)
        if cap is not None:
            kept.append((cap, texts, None, waves, _call_seed(ctx.seed, i)))
        i += 1
        if t1 - run.t_open >= ctx.seconds and i >= max(last if tracer else 0, chk["among"]):
            break
    run.t_close = t1
    run.trace = tracer.result() if tracer is not None else None
    del engine, rec
    serving.judge(ctx, run, served, kept)
    return run
