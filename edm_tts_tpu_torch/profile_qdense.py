"""K5 (int8 weight-only dense) case by case and tile by tile on the card.

    python3 -m edm_tts_tpu_torch.profile_qdense [--served-shapes] [--f32] [--out FILE]

For each case (M, K, N) of ``CASES`` (one request's int8 linears) and
``SERVED_CASES`` (the int8 linears of one served engine call, bucket 4):
K5's device time at the launch ``int8_dense_tile`` picks and at every other
tile of ``INT8_TILES`` whose columns divide N with the K steps split over 1
to ``MAX_SPLITS`` blocks, each held against the plain version (relative l2
within 2^-6); the plain version's time;
``torch.matmul`` in bf16 on the dequantized weight (the cuBLAS yardstick);
``torch._weight_int8pack_mm`` where this PyTorch has it on CUDA; and the
bound (``utils/devtime.py``). Times are device medians (``median_ms``).

With ``--served-shapes`` it first builds the full-width models, quantizes
them behind ``TTSEngine`` (``profile_synthesis.served_engine``), answers
the three served texts in one call and prints each (M, K, N) K5 ran at with
its launch count: what ``SERVED_CASES`` lists. With ``--f32`` the cases run
with f32 activations through K5's f32 kernel instead: every launch of
``INT8_F32_TILES`` with 1 to ``MAX_SPLITS_F32`` splits (relative l2 within
2^-16), beside the f32 matmul on the dequantized weight with TF32 off, the
sweep that ``int8_dense_f32_tile``'s cost model is fitted to. ``--out``
writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

# one request: s2a at M = 150 + 512 (a 500-frame request), t2s at
# M = 128 + 4 + 1250 (text bucket 128), the length predictor at M = 1 + 128,
# and a batch of 4 s2a rows (label, M, K, N)
CASES = (
    *(("s2a", 662, 1024, n) for n in (1024, 2048, 4096, 8192)),
    ("s2a", 662, 4096, 1024), ("s2a", 662, 2048, 1024),
    *(("t2s", 1382, 384, n) for n in (384, 1536, 1024)),
    ("t2s", 1382, 1536, 384), ("t2s", 1382, 768, 384), ("t2s", 1382, 192, 384),
    ("length predictor", 129, 384, 384), ("s2a batch 4", 4 * 662, 1024, 4096),
)
# one served engine call of three requests in bucket 4 (profile_synthesis's
# served batch), as --served-shapes records them: t2s at 4 x 1382 rows, the
# length predictor at 4 x 129, s2a at 4 x 662 and its fine head over the
# 4 x 512 generated frames (every shape but the batch-4 case above); and the
# fine head of a one-row call over its 512 generated frames
SERVED_CASES = (
    *(("served t2s", 5528, k, n) for k, n in ((384, 1536), (1536, 384), (384, 384),
                                               (192, 384), (768, 384), (384, 1024))),
    *(("served length predictor", 516, k, n) for k, n in ((384, 1536), (1536, 384),
                                                           (384, 384), (192, 384), (768, 384))),
    *(("served s2a", 2648, k, n) for k, n in ((1024, 1024), (1024, 2048), (4096, 1024),
                                               (2048, 1024))),
    ("served s2a fine head", 2048, 1024, 8192),
    ("one-row s2a fine head", 512, 1024, 8192),
)


def int8_work(m: int, k: int, n: int, x_bytes: int = 2) -> tuple[int, int]:
    """(products, bytes) of one K5 call: x read once, the int8 weight and
    the f32 scale once, the output (x's dtype, ``x_bytes`` an element)
    written once."""
    return 2 * m * k * n, x_bytes * m * k + k * n + 4 * n + x_bytes * m * n


def case_inputs(m: int, k: int, n: int, gen: torch.Generator, dev) -> tuple:
    """x bf16 (m, k) ~ N(0, 1); the int8 weight of a N(0, 1) matrix with
    column magnitudes U(0.5, 2), and its scale."""
    from edm_tts_tpu_torch.ops import quantize_weight

    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    mag = 0.5 + 1.5 * torch.rand(n, generator=gen, device=dev)
    return (x, *quantize_weight(torch.randn(k, n, generator=gen, device=dev) * mag))


def served_shapes(seed: int) -> dict:
    """(M, K, N) -> K5 launches of one served engine call (three texts)."""
    from edm_tts_tpu_torch.kernels import int8_dense_shapes, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import SERVED_TEXTS, full_width_models, served_engine

    dev = torch.device("cuda", 0)
    t2s, s2a = full_width_models(dev, seed)
    engine = served_engine(t2s, s2a, dev, seed)
    engine.synthesize(list(SERVED_TEXTS[:3]), "spk", seed=1)  # warm-up at these shapes
    reset_launches()
    engine.synthesize(list(SERVED_TEXTS[:3]), "spk", seed=7)
    torch.cuda.synchronize()
    return dict(int8_dense_shapes)


@torch.no_grad()
def profile(cases, seed: int = 0) -> list[dict]:
    """One row per case: times of every tile, the references and the bound."""
    from edm_tts_tpu_torch.ops import int8_dense, int8_dense_reference
    from edm_tts_tpu_torch.ops.qdense import INT8_TILES, MAX_SPLITS, int8_dense_tile
    from edm_tts_tpu_torch.utils.devtime import bound, median_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int8pack = True
    rows = []
    for label, m, k, n in cases:
        x, q, scale = case_inputs(m, k, n, gen, dev)
        ref = int8_dense_reference(x, q, scale).float()
        tiles = {}
        for bn, bm in INT8_TILES:
            for splits in range(1, min(MAX_SPLITS, -(-k // 64)) + 1) if n % bn == 0 else ():
                tile = (bn, bm, splits)
                out = int8_dense(x, q, scale, tile=tile).float()
                rel = ((out - ref).norm() / ref.norm()).item()
                if not rel <= 2.0 ** -6:
                    raise SystemExit(f"profile_qdense: tile {tile} at M{m} K{k} N{n}: "
                                     f"relative l2 {rel}")
                tiles["{}x{}/{}".format(*tile)] = median_ms(
                    lambda: int8_dense(x, q, scale, tile=tile))
        w_deq = (q.float() * scale).bfloat16()
        qt, scale16 = q.t().contiguous(), scale.bfloat16()
        pack_ms = None
        if int8pack:
            try:
                pack_ms = median_ms(lambda: torch._weight_int8pack_mm(x, qt, scale16))
            except (RuntimeError, NotImplementedError, AttributeError):
                int8pack = False
        chosen = "{}x{}/{}".format(*int8_dense_tile(m, k, n, sms))
        bound_ms, bound_by = bound(*int8_work(m, k, n))
        row = dict(case=label, m=m, k=k, n=n, tile=chosen, ms=tiles[chosen], tiles=tiles,
                   plain_ms=median_ms(lambda: int8_dense_reference(x, q, scale)),
                   matmul_bf16_ms=median_ms(lambda: torch.matmul(x, w_deq)),
                   int8pack_mm_ms=pack_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        print(f"{label} M{m} K{k} N{n}: K5 {row['ms']:.4f} ms at tile {row['tile']} "
              f"(tiles {', '.join(f'{t} {v:.4f}' for t, v in tiles.items())}); plain "
              f"{row['plain_ms']:.4f}; bf16 matmul {row['matmul_bf16_ms']:.4f} "
              f"(K5 / matmul {row['ms'] / row['matmul_bf16_ms']:.3f}); _weight_int8pack_mm "
              f"{'n/a' if pack_ms is None else f'{pack_ms:.4f}'}; bound {bound_ms:.4f} "
              f"({bound_by})", flush=True)
    return rows


@torch.no_grad()
def profile_f32(cases, seed: int = 0) -> list[dict]:
    """One row per case for K5's f32 kernel: every launch, the chosen one,
    the f32 matmul and the bound at the 2xTF32 rate."""
    from edm_tts_tpu_torch.ops import int8_dense, int8_dense_reference, quantize_weight
    from edm_tts_tpu_torch.ops.qdense import INT8_F32_TILES, MAX_SPLITS_F32, int8_dense_f32_tile
    from edm_tts_tpu_torch.utils.devtime import PEAK_2XTF32_FLOPS, bound, median_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, m, k, n in cases:
        x = torch.randn(m, k, generator=gen, device=dev)
        mag = 0.5 + 1.5 * torch.rand(n, generator=gen, device=dev)
        q, scale = quantize_weight(torch.randn(k, n, generator=gen, device=dev) * mag)
        ref = int8_dense_reference(x, q, scale)
        tiles = {}
        for bn, bm in INT8_F32_TILES:
            for splits in range(1, min(MAX_SPLITS_F32, k // 32) + 1):
                tile = (bn, bm, splits)
                rel = ((int8_dense(x, q, scale, tile=tile) - ref).norm() / ref.norm()).item()
                if not rel <= 2.0 ** -16:
                    raise SystemExit(f"profile_qdense: f32 tile {tile} at M{m} K{k} N{n}: "
                                     f"relative l2 {rel}")
                tiles["{}x{}/{}".format(*tile)] = median_ms(
                    lambda: int8_dense(x, q, scale, tile=tile))
        w_deq = q.float() * scale
        chosen = "{}x{}/{}".format(*int8_dense_f32_tile(m, k, n, sms))
        best = min(tiles, key=tiles.get)
        bound_ms, bound_by = bound(*int8_work(m, k, n, 4), peak_flops=PEAK_2XTF32_FLOPS)
        row = dict(case=label, m=m, k=k, n=n, tile=chosen, ms=tiles[chosen], best=best,
                   tiles=tiles, matmul_f32_ms=median_ms(lambda: torch.matmul(x, w_deq)),
                   bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        print(f"{label} M{m} K{k} N{n}: K5 f32 {row['ms']:.4f} ms at {chosen} (best {best} "
              f"{tiles[best]:.4f}; {', '.join(f'{t} {v:.4f}' for t, v in tiles.items())}); f32 "
              f"matmul {row['matmul_f32_ms']:.4f}; bound {bound_ms:.4f} ({bound_by})",
              flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--served-shapes", action="store_true",
                        help="first print the K5 shapes of one served engine call")
    parser.add_argument("--f32", action="store_true",
                        help="sweep K5's f32 kernel (f32 activations) instead")
    parser.add_argument("--out", type=Path, default=None, help="JSON file for the rows")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_qdense: needs a CUDA device")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.served_shapes:
        shapes = served_shapes(args.seed)
        for (m, k, n), count in sorted(shapes.items()):
            print(f"served engine call: K5 at M{m} K{k} N{n}: {count} launches", flush=True)
        print(f"served engine call: {sum(shapes.values())} K5 launches", flush=True)
        torch.cuda.empty_cache()
    if args.f32:
        rows = profile_f32(CASES + SERVED_CASES, args.seed)
        for name, part in (("one request", rows[:len(CASES)]), ("served", rows[len(CASES):])):
            print(f"sum over the {name} cases: K5 f32 {sum(r['ms'] for r in part):.4f} ms at "
                  f"the chosen launches, {sum(r['tiles'][r['best']] for r in part):.4f} at the "
                  f"best, f32 matmul {sum(r['matmul_f32_ms'] for r in part):.4f}, bound "
                  f"{sum(r['bound_ms'] for r in part):.4f} ({smi})", flush=True)
    else:
        rows = profile(CASES + SERVED_CASES, args.seed)
        for name, part in (("one request", rows[:len(CASES)]), ("served", rows[len(CASES):])):
            k5 = sum(r["ms"] for r in part)
            mm = sum(r["matmul_bf16_ms"] for r in part)
            print(f"sum over the {name} cases: K5 {k5:.4f} ms, bf16 matmul {mm:.4f} ms "
                  f"(K5 / matmul {k5 / mm:.3f}), bound {sum(r['bound_ms'] for r in part):.4f} "
                  f"ms ({smi})", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(device=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
