"""K3-f32 (f32 attention forward with its LSE) case by case and tile by tile
on the card.

    python3 -m edm_tts_tpu_torch.profile_attention_f32 [--n 20] [--out FILE]

For each case of ``CASES`` (the f32 path's inference shapes: HuBERT-large
on a 3 s and a 10 s prompt and its masked batch, the t2s canvas, the s2a
at one request and at a full canvas) and ``TRAIN_CASES`` (the shapes f32
training launches it at): K3-f32's device time with its LSE at every query
tile of ``ops.attention.QUERY_TILES_F32``, each held against the plain
version (relative l2 within 2^-16), the tile ``attention_f32_query_tile``
picks, ``scaled_dot_product_attention`` on the same f32 inputs with TF32
off (the library yardstick) and the bound at the 3xTF32 rate
(``utils/devtime.py``). Times are device medians (``median_ms``); the
chooser is fitted to them. The first line is the card's name and power
limit. ``--out`` writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

# label: (B, T, H, D, key lengths or None)
CASES = (
    ("hubert B1 T150 H16 D64", (1, 150, 16, 64, None)),
    ("hubert B1 T500 H16 D64", (1, 500, 16, 64, None)),
    ("hubert B4 T500 H16 D64 mask", (4, 500, 16, 64, (150, 275, 400, 500))),
    ("t2s T604 H8 D24 mask", (1, 604, 8, 24, (553,))),
    ("s2a T650 H16 D64", (1, 650, 16, 64, None)),
    ("s2a T1250 H16 D64 mask", (1, 1250, 16, 64, (1199,))),
)
# the s2a training micro-batch, a masked ragged batch and the masked t2s
# canvas (also the bf16 K3's and K4's training cases)
TRAIN_CASES = (
    ("s2a train B8 T768 H16 D64", (8, 768, 16, 64, None)),
    ("ragged B4 T701 H8 D24 mask", (4, 701, 8, 24, (701, 650, 512, 97))),
    ("t2s canvas B4 T1382 H8 D24 mask", (4, 1382, 8, 24, (1382, 1210, 905, 488))),
)
REL_L2_TOL = 2.0 ** -16


def work(b: int, t: int, h: int, d: int, n_keys: int) -> tuple[float, float, float]:
    """(FLOP of the two products over the ``n_keys`` keys that count,
    summed over the batch rows; bytes of q, k, v, o, the mask and the LSE;
    exponentials) of one f32 launch with its LSE."""
    return (4.0 * h * t * n_keys * d, 4 * (4 * b * t * h * d) + b * t + 4 * b * h * t,
            float(h * t * n_keys))


def inputs(b: int, t: int, h: int, d: int, lens, seed: int = 0):
    """Seeded f32 q, k, v ~ N(0, 1) on the card and the key mask (or None)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(3))
    mask = None if lens is None else (
        torch.arange(t, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None])
    return q, k, v, mask


def main() -> None:
    import torch.nn.functional as F

    from edm_tts_tpu_torch import ops
    from edm_tts_tpu_torch.kernels import sm_count
    from edm_tts_tpu_torch.utils.devtime import PEAK_3XTF32_FLOPS, bound, median_ms

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=20, help="timed runs per launch")
    parser.add_argument("--out", default=None, help="write the rows as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention_f32: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sms = sm_count(0)
    rows = []
    for label, (b, t, h, d, lens) in CASES + TRAIN_CASES:
        q, k, v, mask = inputs(b, t, h, d, lens)
        ref = ops.mha_reference(q, k, v, mask=mask)
        row = dict(case=label, b=b, t=t, h=h, d=d, lens=lens,
                   picked=ops.attention.attention_f32_query_tile(b, h, t, d, sms), tiles={})
        for block_q in ops.attention.QUERY_TILES_F32:
            out = ops.flash_mha(q, k, v, mask=mask, return_lse=True, block_q=block_q)[0]
            rel = ((out - ref).norm() / ref.norm()).item()
            if not rel <= REL_L2_TOL:
                raise SystemExit(f"{label} block_q {block_q}: relative l2 {rel} above "
                                 f"{REL_L2_TOL}")
            row["tiles"][block_q] = median_ms(
                lambda: ops.flash_mha(q, k, v, mask=mask, return_lse=True, block_q=block_q),
                args.n)
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        row["sdpa_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask), args.n)
        flops, nbytes, exps = work(b, t, h, d, b * t if lens is None else sum(lens))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, exps, PEAK_3XTF32_FLOPS)
        rows.append(row)
        tiles = ", ".join(f"{bq}: {ms:.4f}" for bq, ms in row["tiles"].items())
        print(f"K3-f32 {label}: ms by block_q {{{tiles}}} picked {row['picked']} "
              f"({row['tiles'][row['picked']]:.4f}) sdpa_f32 {row['sdpa_ms']:.4f} "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    picked = sum(r["tiles"][r["picked"]] for r in rows[:len(CASES)])
    best = sum(min(r["tiles"].values()) for r in rows[:len(CASES)])
    sdpa = sum(r["sdpa_ms"] for r in rows[:len(CASES)])
    print(f"K3-f32 over the {len(CASES)} inference cases: picked {picked:.4f} ms, each case's "
          f"fastest tile {best:.4f}, sdpa_f32 {sdpa:.4f} ({smi})", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
