"""The attention-variant ablation on the card (port of
scripts/profile_attn_variants.py).

    python3 -m edm_tts_tpu_torch.profile_attn_variants [--n 20]

At B32, T1408, H16, D24 in bf16 (the t2s training shape the TPU script
took) it prints one line per (variant, query tile) of kernel K6
(``ops.attn_variant``: full, noexp, nosoftmax, bf16exp; 64 or 128 query
rows per block) with its device median and the least time the card could
take (``utils.devtime.bound``: bytes, products and exponentials); then K3
(``ops.flash_mha``) without a mask, with an all-true mask and with that
mask and its LSE; then ``scaled_dot_product_attention`` on the same inputs
as the library yardstick. Timing is chip_smoke.py's protocol
(``utils.devtime.median_ms``). The first line is the card's name and power
limit.

``inputs``, ``work`` and ``sweep`` are what chip_smoke.py drives for its
path (f).
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.ops.attn_variants import BLOCK_Q, VARIANTS, attn_variant
from edm_tts_tpu_torch.utils.devtime import bound, median_ms

SHAPE = (32, 1408, 16, 24)  # B, T, H, D


def inputs(shape=SHAPE, seed: int = 0) -> tuple[torch.Tensor, ...]:
    """Seeded q, k, v ~ N(0, 1) in bf16 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(*shape, generator=gen, device="cuda").bfloat16() for _ in range(3))


def work(variant: str, b: int, t: int, h: int, d: int) -> tuple[float, float, float]:
    """(FLOP of the two products, bytes of q, k, v and o, MUFU operations)
    of one unmasked attention variant; ``full`` and K3 take one exponential
    per score, ``bf16exp`` one per pair of scores."""
    scores = b * h * t * t
    exps = {"full": scores, "bf16exp": scores / 2}.get(variant, 0.0)
    return 4.0 * scores * d, 4.0 * b * t * h * d * 2, exps


def sweep(q, k, v, n: int = 20) -> list[dict]:
    """Each variant at each query tile: device median ms and the bound."""
    rows = []
    for block_q in BLOCK_Q:
        for variant in VARIANTS:
            ms = median_ms(lambda: attn_variant(q, k, v, variant=variant, block_q=block_q), n)
            bound_ms, bound_by = bound(*work(variant, *q.shape))
            rows.append(dict(variant=variant, block_q=block_q, ms=ms, bound_ms=bound_ms,
                             bound_by=bound_by))
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=20, help="timed runs per median")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    q, k, v = inputs()
    b, t, h, d = q.shape
    label = f"B{b} T{t} H{h} D{d}"
    for row in sweep(q, k, v, args.n):
        print(f"K6 {label} {row['variant']:9s} block_q {row['block_q']:3d}: {row['ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    flops, nbytes, exps = work("full", b, t, h, d)
    k3_bound, k3_by = bound(flops, nbytes + b * t, exps)  # and the mask's bytes
    for name, fn in (("no mask", lambda: ops.flash_mha(q, k, v)),
                     ("mask", lambda: ops.flash_mha(q, k, v, mask=mask)),
                     ("mask + LSE", lambda: ops.flash_mha(q, k, v, mask=mask, return_lse=True))):
        print(f"K3 {label} {name}: {median_ms(fn, args.n):.4f} ms, bound {k3_bound:.4f} ms "
              f"({k3_by})", flush=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), args.n)
    print(f"scaled_dot_product_attention {label} (B, H, T, D layout, made untimed): "
          f"{sdpa:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
