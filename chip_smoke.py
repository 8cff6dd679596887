#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (edm_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. environment: torch / CUDA versions and the card's name and power limit;
  2. build: nvcc builds the kernels from edm_tts_tpu_torch/csrc;
  3. kernels: each hand-written kernel (K1 residual unit, K2 decoder block,
     K3 attention) against its plain PyTorch version at the synthesis
     path's own shapes in bf16: relative l2 and max abs error within their
     limits, planted faults of the plain version outside them, median times
     of both;
  4. end to end: full-width models (the default codec and s2a, the t2s of
     bench.py; edm_tts_tpu_torch/profile_synthesis.py builds them) from a
     seeded random init in bf16 answer (a) a 10 s request
     with a given length on a full canvas, as bench.py runs it, and (b) a
     request that uses the length predictor and the masked canvas; checks
     shapes, finite non-silent audio, codes in range, the kernels' launch
     counts, and the decode against the plain versions; prints the wall
     seconds per second of audio of (a).
The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
There is no CPU fallback: without a CUDA device the script fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
# Kernel against plain version: the relative l2 error ||out - ref|| / ||ref||
# must stay under REL_L2_TOL. Kernel and plain version round intermediates
# to bf16 at different points, which leaves ~0.3 % (K1, K2) to ~0.6 % (K3);
# leaving out a bias or a snake alpha, dropping the keys of a tail tile,
# ignoring the mask or scaling by the padded head depth moves it by 8 % or
# more. Each case also shows, on the
# plain version, that the limit rejects such planted faults.
REL_L2_TOL = 2.0 ** -6
# and no element may be off by more than 2^-5 of the output's largest
# magnitude (4-8 bf16 ulps there): catches a few rows gone wrong, which
# barely move a relative l2 error over millions of elements
MAX_ABS_TOL = 2.0 ** -5

KERNELS = {
    "resunit": dict(source="edm_tts_tpu_torch/csrc/resunit.cu",
                    replaces="edm_tts_tpu/ops/pallas_resunit.py:190"),
    "decoder_block": dict(source="edm_tts_tpu_torch/csrc/decoder_block.cu",
                          replaces="edm_tts_tpu/ops/pallas_decoder_block.py:287"),
    "attention": dict(source="edm_tts_tpu_torch/csrc/attention.cu",
                      replaces="edm_tts_tpu/ops/pallas_attention.py:83"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def median_ms(torch, fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_l2(torch, out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def kernel_phase(torch, ops) -> dict:
    """Each kernel against its plain version at the slice's shapes.

    Alphas are drawn U(0.5, 2) and biases N(0, 0.5), so that every term of
    the arithmetic moves the output by more than the limit.
    """
    from edm_tts_tpu_torch.ops.decoder_block import phase_weights

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def uniform(*shape, lo, hi):
        return lo + torch.rand(*shape, generator=gen, device=dev) * (hi - lo)

    def alpha(c):
        return uniform(c, lo=0.5, hi=2.0)

    def resunit_params(c):
        """(alpha1, w7, b7, alpha2, w1, b1) as K1 takes them."""
        b7 = (7 * c) ** -0.5
        return (alpha(c), uniform(7, c, c, lo=-b7, hi=b7).to(bf16), normal(c, scale=0.5),
                alpha(c), uniform(1, c, c, lo=-c ** -0.5, hi=c ** -0.5).to(bf16),
                normal(c, scale=0.5))

    def replaced(params, i, value):
        return tuple(value if j == i else p for j, p in enumerate(params))

    cases: dict[str, list] = {name: [] for name in KERNELS}

    def compare(name, label, kernel, plain, faults):
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail(f"{label}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        max_abs_tol = MAX_ABS_TOL * ref.float().abs().max().item()
        rel = rel_l2(torch, out, ref)
        fault_rel = {f: rel_l2(torch, fn(), ref) for f, fn in faults.items()}
        ms, plain_ms = median_ms(torch, kernel), median_ms(torch, plain)
        print(f"kernel {name} {label}: rel_l2 {rel:.6g} (tol {REL_L2_TOL:.6g}) max_abs_err "
              f"{err:.6g} (tol {max_abs_tol:.4g}) planted faults rel_l2 "
              f"{ {f: round(r, 5) for f, r in fault_rel.items()} } "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f}", flush=True)
        if rel > REL_L2_TOL or err > max_abs_tol:
            fail(f"{label}: rel l2 {rel} / max abs {err} above {REL_L2_TOL} / {max_abs_tol}")
        weak = [f for f, r in fault_rel.items() if r <= REL_L2_TOL]
        if weak:
            fail(f"{label}: the limit would let the planted faults {weak} pass")
        cases[name].append(dict(case=label, rel_l2=rel, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, planted_fault_rel_l2=fault_rel))

    # K1: decoder blocks 0 and 1 (C 768 at T 4000, C 384 at T 20002)
    for t, c in ((4000, 768), (20002, 384)):
        x = normal(1, t, c).to(bf16)
        for d in (1, 3, 9):
            p = resunit_params(c)
            compare("resunit", f"T{t} C{c} dil{d}",
                    lambda: ops.fused_residual_unit(x, *p, d),
                    lambda: ops.resunit_reference(x, *p, dilation=d),
                    {"b1 dropped": lambda: ops.resunit_reference(
                        x, *replaced(p, 5, p[5] * 0), dilation=d),
                     "alpha1 = 1": lambda: ops.resunit_reference(
                        x, *replaced(p, 0, p[0] * 0 + 1), dilation=d)})
    # K2: the s=4 and s=2 tail blocks
    for s, t, cin, cout in ((4, 20002, 384, 192), (2, 80008, 192, 96)):
        x = normal(1, t, cin).to(bf16)
        a0 = alpha(cin)
        bound = (2 * s * cout) ** -0.5
        w3 = phase_weights(uniform(2 * s, cin, cout, lo=-bound, hi=bound).to(bf16), s).contiguous()
        bias3 = normal(cout, scale=0.5).repeat(s)
        rus = [resunit_params(cout) for _ in range(3)]
        compare("decoder_block", f"s{s} T{t} C{cin}->{cout}",
                lambda: ops.fused_decoder_block(x, a0, w3, bias3, rus, s),
                lambda: ops.decoder_block_reference(x, a0, w3, bias3, rus, stride=s),
                {"bias dropped": lambda: ops.decoder_block_reference(
                    x, a0, w3, bias3 * 0, rus, stride=s),
                 "alpha0 = 1": lambda: ops.decoder_block_reference(
                    x, a0 * 0 + 1, w3, bias3, rus, stride=s)})
    # K3: t2s (masked canvas), the length predictor, s2a without and with a
    # key mask. The t2s and s2a masks also cover the first 70 keys, so every
    # row's first KV tile is fully masked.
    for label, (t, h, d, lo, hi) in (("t2s T604 H8 D24 mask", (604, 8, 24, 70, 553)),
                                     ("length predictor T101 H8 D24 mask", (101, 8, 24, 0, 90)),
                                     ("s2a T650 H16 D64", (650, 16, 64, None, None)),
                                     ("s2a T650 H16 D64 mask", (650, 16, 64, 70, 599))):
        q, k, v = (normal(1, t, h, d).to(bf16) for _ in range(3))
        pos = torch.arange(t, device=dev)[None]
        mask = None if lo is None else (pos >= lo) & (pos < hi)
        valid = torch.ones_like(pos, dtype=torch.bool) if mask is None else mask
        faults = {}
        tail = valid & (pos < t // 64 * 64)  # the keys of the last, partial tile dropped
        if not torch.equal(tail, valid):
            faults["tail tile dropped"] = lambda: ops.mha_reference(q, k, v, mask=tail)
        if mask is not None:
            faults["mask ignored"] = lambda: ops.mha_reference(q, k, v)
        if d % 32:  # scaled by the depth the kernel pads D to, not by D
            faults["scaled by padded D"] = lambda: ops.mha_reference(
                q * (d / (-(-d // 32) * 32)) ** 0.5, k, v, mask=mask)
        compare("attention", label, lambda: ops.flash_mha(q, k, v, mask=mask),
                lambda: ops.mha_reference(q, k, v, mask=mask), faults)
    return cases


def decode_plain(torch, ops, codec, codes):
    """The codec decode of ``codes`` through the kernels' plain versions."""
    x = codec.quantizer.from_codes(codes).to(codec.dtype)
    stem, *blocks, snake, final = codec.decoder.model
    x = stem(x)
    for block in blocks:
        snake0, tconv, *units = block.block
        x = tconv(snake0(x))
        for u in units:
            x = ops.resunit_reference(x, *u.folded(), dilation=u.dilation)
    return torch.tanh(final(snake(x)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU")
    from edm_tts_tpu_torch import ops
    from edm_tts_tpu_torch.kernels import build, launches, reset_launches
    from edm_tts_tpu_torch.models.s2a import s2a_sample
    from edm_tts_tpu_torch.models.t2s import t2s_sample
    from edm_tts_tpu_torch.pipeline import e2e_synthesize
    from edm_tts_tpu_torch.profile_synthesis import (
        GEN_FRAMES,
        PRED_ITERS,
        STEPS,
        bench_inputs,
        full_width_models,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernels against their plain versions
    cases = kernel_phase(torch, ops)

    # 4. end to end at full width
    t0 = time.perf_counter()
    t2s, s2a = full_width_models(dev, SEED)
    t2s_cfg, s2a_cfg = t2s.cfg, s2a.cfg
    n_params = sum(p.numel() for m in (s2a, t2s) for p in m.parameters())
    print(f"models: {n_params / 1e6:.1f}M parameters in {time.perf_counter() - t0:.2f} s", flush=True)
    inp = bench_inputs(s2a_cfg, dev, SEED)
    text, text_len, gt_length = inp["text"], inp["text_len"], inp["gt_length"]
    prompt_ac, prompt_sem = inp["prompt_ac"], inp["prompt_sem"]
    hop = s2a_cfg.codec.hop_length
    n_samples = s2a.acoustic_model.decoded_length(GEN_FRAMES)

    def request(full_canvas: bool, seed: int):
        return e2e_synthesize(
            t2s, s2a, text, text_len, prompt_ac, prompt_sem,
            torch.Generator().manual_seed(seed), pred_iters=PRED_ITERS, steps=STEPS,
            max_speech_len=GEN_FRAMES, gt_length=gt_length if full_canvas else None,
            assume_full_canvas=full_canvas,
        )

    def expected_launches(full_canvas: bool) -> dict:
        attention = (t2s_cfg.main_encoder_num_layers * PRED_ITERS
                     + (0 if full_canvas else t2s_cfg.length_predictor_num_layers)
                     + (s2a_cfg.injection_layers[0] + 1) * STEPS + s2a_cfg.encoder_num_layers)
        # K2 takes the blocks the JAX package fuses: even stride dividing 40,
        # C_out <= 192 (decoder.py); K1 every residual unit of the decoder
        codec = s2a_cfg.codec
        fused = sum(1 for i, s in enumerate(codec.decoder_rates)
                    if s % 2 == 0 and 40 % s == 0 and codec.decoder_dim // 2 ** (i + 1) <= 192)
        return {"resunit": 3 * len(codec.decoder_rates), "decoder_block": fused,
                "attention": attention}

    def check(label: str, out, full_canvas: bool, counts: dict):
        audio = out["audio"]
        if tuple(audio.shape) != (1, n_samples, 1):
            fail(f"{label}: audio shape {tuple(audio.shape)} != (1, {n_samples}, 1)")
        length = int(out["lengths"][0])
        valid = audio[:, : length * hop].float()
        rms = valid.square().mean().sqrt().item()
        if not torch.isfinite(audio).all() or not rms > 0:
            fail(f"{label}: audio not finite or silent (rms {rms})")
        codes, sem = out["acoustic_codes"], out["semantic_tokens"]
        if tuple(codes.shape) != (1, s2a_cfg.num_quantizers, GEN_FRAMES):
            fail(f"{label}: codes shape {tuple(codes.shape)}")
        if codes.min() < 0 or codes.max() >= s2a_cfg.num_codevectors:
            fail(f"{label}: codes out of range")
        if sem.min() < 0 or sem.max() >= t2s_cfg.semantic_vocab_size:
            fail(f"{label}: semantic tokens out of range")
        want = expected_launches(full_canvas)
        print(f"e2e {label}: audio {tuple(audio.shape)} length {length} frames "
              f"rms {rms:.4f} launches {counts} expected {want}", flush=True)
        if counts != want:
            fail(f"{label}: kernel launches {counts} != expected {want}")

    # (a) bench.py's request: gt_length 500 on the full canvas
    reset_launches()
    out_a = request(True, SEED)
    torch.cuda.synchronize()
    counts_a = dict(launches)
    check("(a) full canvas", out_a, True, counts_a)

    # the same codes decoded through the plain versions agree with the kernels
    plain_audio = decode_plain(torch, ops, s2a.acoustic_model, out_a["acoustic_codes"])
    rel = rel_l2(torch, out_a["audio"], plain_audio)
    print(f"e2e (a) decode vs plain versions: relative l2 error {rel:.4g} (tol 0.05)", flush=True)
    if not rel <= 0.05:  # bf16 through 17 conv stages rounded at other points
        fail(f"decode differs from the plain versions: relative error {rel}")

    # (b) the length predictor and the masked canvas
    reset_launches()
    out_b = request(False, SEED + 1)
    torch.cuda.synchronize()
    check("(b) predicted length", out_b, False, dict(launches))

    # wall seconds per second of audio of (a), after the warm-up above
    audio_s = GEN_FRAMES * hop / s2a_cfg.codec.sample_rate
    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request(True, SEED + 10 + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"e2e (a) rtf: {wall / audio_s:.5f} s per audio s (median wall {wall:.4f} s of "
          f"{[round(w, 4) for w in walls]}, {audio_s:.1f} s audio, {smi})", flush=True)

    # where the wall time of (a) goes, stage by stage
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    gen = torch.Generator().manual_seed(SEED + 20)
    t2s_out, t_t2s = timed(lambda: t2s_sample(
        t2s, text, text_len, gen, pred_iters=PRED_ITERS, max_speech_len=GEN_FRAMES,
        gt_length=gt_length))
    codes, t_s2a = timed(lambda: s2a_sample(
        s2a, t2s_out["semantic_tokens"], prompt_ac, prompt_sem, gen, steps=STEPS))
    _, t_dec = timed(lambda: s2a.decode_audio(codes))
    print(f"e2e (a) stages: t2s {t_t2s:.4f} s, s2a {t_s2a:.4f} s, decode {t_dec:.4f} s", flush=True)

    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name], launches=counts_a[name],
             max_abs_err=max(c["max_abs_err"] for c in cases[name]),
             rel_l2=max(c["rel_l2"] for c in cases[name]),
             ms=sum(c["ms"] for c in cases[name]),
             plain_ms=sum(c["plain_ms"] for c in cases[name]),
             cases=cases[name])
        for name in KERNELS
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
