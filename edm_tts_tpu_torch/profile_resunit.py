"""K1 (the codec residual unit) case by case on the card.

    python3 -m edm_tts_tpu_torch.profile_resunit [--out FILE]

For each case of ``CASES`` (the 12 residual units of one 500-frame decode,
run (a)), ``SERVED_CASES`` (the 12 of one served engine call in bucket
4: four rows on a 512-frame canvas, through the ``valid_frames`` decode)
and ``ENCODER_CASES`` (the 12 of the codec encoder on one 10 s prompt,
path (g)):
K1's device time at the N tile ``ops.resunit.resunit_tile`` picks, held
against the plain version (relative l2 within 2^-6), and its split over
K1's three launches (the snake of x, the k=7 product, the k=1 product:
device time per call from ``torch.profiler``); the bound
(``utils/devtime.py``); and, as information only, the two library calls
that compute the unit's two convolutions (``F.conv1d`` of the dilated k=7
conv on the (B, C, T) layout, which cuDNN runs, plus ``torch.matmul`` of
the k=1 conv; neither does the snakes, the biases or the residual).
Weights come from a seeded ``ResidualUnit`` through its ``pack``, so the
kernel gets the layout the model gives it. Times are device medians
(``median_ms``). The first line is the card's name and power limit; the
last lines sum each set. ``--out`` writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from edm_tts_tpu_torch.models.codec import CodecConfig
from edm_tts_tpu_torch.models.codec.layers import ResidualUnit, norm_but_first
from edm_tts_tpu_torch.ops import resunit as resunit_ops
from edm_tts_tpu_torch.ops.convolution import conv1d_output_length
from edm_tts_tpu_torch.utils.devtime import bound, median_ms

DILATIONS = (1, 3, 9)


def decoder_units(frames: int, batch: int, cfg: CodecConfig = CodecConfig()) -> tuple:
    """(label, B, T, C, dilation) of every residual unit of a decode of
    ``frames`` 50 Hz frames: block i runs at C = channels / 2^(i+1) and
    T = the frames upsampled by the first i+1 strides (an odd stride adds
    2 samples)."""
    cases, t = [], frames
    for i, s in enumerate(cfg.decoder_rates):
        t = s * t + (2 if s % 2 else 0)
        c = cfg.decoder_dim // 2 ** (i + 1)
        cases += [(f"B{batch} T{t} C{c} dil{d}", batch, t, c, d) for d in DILATIONS]
    return tuple(cases)


# run (a): one request's decode of 500 frames
CASES = decoder_units(500, 1)
# one served engine call: bucket 4, the 512-frame canvas the ~480-frame
# lengths round up to (profile_synthesis.served_engine)
SERVED_CASES = decoder_units(512, 4)
# a one-row engine call on the same canvas (a served request with its own
# length); chip_smoke.py holds K1 at these too
ONE_ROW_CASES = decoder_units(512, 1)


def encoder_units(samples: int, batch: int, cfg: CodecConfig = CodecConfig()) -> tuple:
    """(label, B, T, C, dilation) of every residual unit of the codec encoder
    on ``samples`` padded samples: block i runs at C = encoder_dim * 2^i and
    the length its strided predecessors leave (k = 2s, padding ceil(s/2))."""
    cases, t = [], samples
    for i, s in enumerate(cfg.encoder_rates):
        c = cfg.encoder_dim * 2 ** i
        cases += [(f"enc B{batch} T{t} C{c} dil{d}", batch, t, c, d) for d in DILATIONS]
        t = conv1d_output_length(t, 2 * s, stride=s, padding=-(-s // 2))
    return tuple(cases)


# path (g): the encoder on one 10 s prompt, 160000 samples at 16 kHz after
# the tokenizer's alignment pad (+80 on each side): C 64 at T 160160 ... C 512
# at T 4004
ENCODER_CASES = encoder_units(160160, 1)


def resunit_work(b: int, t: int, c: int) -> tuple[int, int]:
    """(products, bytes) of one unit: the k=7 and k=1 products; x read and
    the output written once, the two kernels once, four f32 vectors."""
    return 2 * b * t * c * c * 8, 2 * 2 * b * t * c + 8 * c * c * 2 + 4 * c * 4


def launch_parts(fn, n: int = 5) -> dict[str, float]:
    """Device ms per call of each of K1's three launches in ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = {"snake": 0.0, "k7": 0.0, "k1": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "edm::" not in e.key:
            continue
        part = ("snake" if "snake_kernel" in e.key
                else "k7" if ", 7, 0>" in e.key else "k1" if ", 1, 1>" in e.key else None)
        if part is not None:
            parts[part] += e.self_device_time_total / 1e3 / n
    return parts


def seeded_unit(c: int, dilation: int, gen: torch.Generator) -> ResidualUnit:
    """A bf16 ResidualUnit on the card with alphas U(0.5, 2), kernels
    U(+-fan_in^-1/2) and biases N(0, 0.5), packed for K1."""
    unit = ResidualUnit(c, dilation, device="cuda", dtype=torch.bfloat16)
    s1, c7, s2, c1 = unit.block
    with torch.no_grad():
        for snake in (s1, s2):
            snake.alpha.copy_(0.5 + 1.5 * torch.rand(snake.alpha.shape, generator=gen,
                                                     device="cuda"))
        for conv in (c7, c1):
            v = conv.weight_v
            fan_in = v.shape[1] * v.shape[2]
            v.copy_((torch.rand(v.shape, generator=gen, device="cuda") * 2 - 1) * fan_in ** -0.5)
            conv.weight_g.copy_(norm_but_first(v))
            conv.bias.copy_(0.5 * torch.randn(c, generator=gen, device="cuda"))
            conv.fold(v)
    unit.pack()
    return unit


@torch.no_grad()
def profile(cases, seed: int = 0) -> list[dict]:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for label, b, t, c, d in cases:
        x = torch.randn(b, t, c, generator=gen, device="cuda").bfloat16()
        unit = seeded_unit(c, d, gen)
        out = resunit_ops.fused_residual_unit(x, *unit.kernel_args, d)
        ref = resunit_ops.resunit_reference(x, *unit.folded(), dilation=d)
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        if not rel <= 2.0 ** -6:
            raise SystemExit(f"profile_resunit: {label}: K1 off its plain version, rel l2 {rel}")
        del out, ref
        ms = median_ms(lambda: resunit_ops.fused_residual_unit(x, *unit.kernel_args, d))
        parts = launch_parts(lambda: resunit_ops.fused_residual_unit(x, *unit.kernel_args, d))
        # the library's two convolutions on their own layouts (made untimed)
        c7, c1 = unit.block[1], unit.block[3]
        xt = x.transpose(1, 2).contiguous()
        w1 = c1.weight[:, :, 0].t().contiguous()
        conv_ms = median_ms(lambda: F.conv1d(xt, c7.weight, c7.bias, padding=3 * d, dilation=d))
        mm_ms = median_ms(lambda: torch.matmul(x, w1))
        bound_ms, bound_by = bound(*resunit_work(b, t, c))
        tile = resunit_ops.resunit_tile(b, t, c, sms)
        rows.append(dict(case=label, b=b, t=t, c=c, dilation=d, tile=tile, ms=ms, rel_l2=rel,
                         parts_ms=parts, conv1d_ms=conv_ms, matmul_ms=mm_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K1 {label}: {ms:.4f} ms at N tile {tile} (snake {parts['snake']:.4f}, k=7 "
              f"product {parts['k7']:.4f}, k=1 product {parts['k1']:.4f}), rel l2 {rel:.3g}; library "
              f"F.conv1d {conv_ms:.4f} + matmul {mm_ms:.4f} = {conv_ms + mm_ms:.4f} ms "
              f"(K1 / library {ms / (conv_ms + mm_ms):.3f}); bound {bound_ms:.4f} "
              f"({bound_by})", flush=True)
        del x, xt, unit
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=None, help="JSON file for the rows")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_resunit: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = profile(CASES + SERVED_CASES + ENCODER_CASES, args.seed)
    n_a, n_c = len(CASES), len(CASES) + len(SERVED_CASES)
    for name, part in (("run (a)", rows[:n_a]), ("served", rows[n_a:n_c]),
                       ("encoder (g)", rows[n_c:])):
        lib = sum(r["conv1d_ms"] + r["matmul_ms"] for r in part)
        print(f"sum over the {len(part)} {name} cases: K1 {sum(r['ms'] for r in part):.4f} ms, "
              f"library {lib:.4f} ms, bound {sum(r['bound_ms'] for r in part):.4f} ms ({smi})",
              flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(device=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
