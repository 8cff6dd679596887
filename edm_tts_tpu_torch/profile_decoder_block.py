"""K2 (the codec decoder block) case by case on the card.

    python3 -m edm_tts_tpu_torch.profile_decoder_block [--sweep] [--parent DIR] [--out FILE]

For each case of ``CASES`` (the blocks of one 500-frame decode, run (a),
that K2 takes: even stride dividing 40 and C_out <= 192, as the JAX
package fuses them): K2's front (``ops.decoder_block.tconv_phase``: the
snake pass and the phase product) at the column tile
``decoder_block_tile`` picks, held against its plain version (relative l2
within 2^-6), split over its two launches by ``torch.profiler`` (device
time per call); the three residual units (K1) and the whole block; the
bound of each (``utils/devtime.py``; the front's products counted at the
two nonzero taps of each phase); and, as information only, cuDNN's
``F.conv_transpose1d`` on the snake'd input in the channels-first layout
(the layout changes untimed; it does neither the snake nor the tiled bias
layout). ``--sweep`` also times the front at every tile of
``DECODER_BLOCK_TILES``. ``--parent DIR`` builds the K2 front of another
checkout of this repository (``DIR/edm_tts_tpu_torch/csrc/decoder_block.cu``
with the entry point ``edm_tconv_phase(x, a0, w3, bias3, out, B, T, C_in,
N, stream)``, as it stood before the tap-skipping GEMM) and times it beside
this one, in the order parent, this, this, parent. Times are device
medians (``median_ms``). The first line is the card's name and power
limit; the last lines sum the cases. ``--out`` writes the rows as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from edm_tts_tpu_torch.kernels.build import BUILD_DIR, build_sources, check_launch
from edm_tts_tpu_torch.models.codec import CodecConfig
from edm_tts_tpu_torch.models.codec.decoder import _FUSED_HALO
from edm_tts_tpu_torch.ops import decoder_block as block_ops
from edm_tts_tpu_torch.ops.resunit import fused_residual_unit
from edm_tts_tpu_torch.profile_resunit import resunit_work
from edm_tts_tpu_torch.utils.devtime import bound, median_ms


def decoder_blocks(frames: int, batch: int, cfg: CodecConfig = CodecConfig()) -> tuple:
    """(label, B, T, C_in, C_out, stride) of every block of a decode of
    ``frames`` 50 Hz frames that K2 takes; T is the frames entering it."""
    cases, t = [], frames
    for i, s in enumerate(cfg.decoder_rates):
        cin, cout = cfg.decoder_dim // 2 ** i, cfg.decoder_dim // 2 ** (i + 1)
        if s % 2 == 0 and _FUSED_HALO % s == 0 and cout <= 192:  # DecoderBlock.fused
            cases.append((f"s{s} B{batch} T{t} C{cin}->{cout}", batch, t, cin, cout, s))
        t = s * t + (2 if s % 2 else 0)
    return tuple(cases)


# run (a): one request's decode of 500 frames (s4 T20002 384->192, s2
# T80008 192->96)
CASES = decoder_blocks(500, 1)


def front_work(b: int, t: int, cin: int, cout: int, s: int) -> tuple[int, int]:
    """(products, bytes) of the front: two nonzero taps per phase; x read
    and the output written once, w3's nonzero two thirds, alpha and bias."""
    n = s * cout
    return (2 * b * t * 2 * cin * n,
            2 * b * t * cin + 2 * b * t * n + 2 * 2 * cin * n + 4 * (cin + n))


def block_params(b, t, cin, cout, s, gen):
    """x, alpha0, the transposed-conv kernel (2s, C_in, C_out), w3, bias3 and
    three units' parameters on the card: alphas U(0.5, 2), kernels
    U(+-fan_in^-1/2), biases N(0, 0.5), as chip_smoke.py draws them."""
    def u(*shape, lim):
        return ((torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * lim).bfloat16()

    def alpha(c):
        return 0.5 + 1.5 * torch.rand(c, generator=gen, device="cuda")

    def bias(c):
        return 0.5 * torch.randn(c, generator=gen, device="cuda")

    x = torch.randn(b, t, cin, generator=gen, device="cuda").bfloat16()
    wt = u(2 * s, cin, cout, lim=(2 * s * cout) ** -0.5)
    w3 = block_ops.phase_weights(wt, s).contiguous()
    rus = [(alpha(cout), u(7, cout, cout, lim=(7 * cout) ** -0.5), bias(cout), alpha(cout),
            u(1, cout, cout, lim=cout ** -0.5), bias(cout)) for _ in range(3)]
    return x, alpha(cin), wt, w3, bias(cout).repeat(s), rus


def front_parts(fn, n: int = 5) -> dict[str, float]:
    """Device ms per call of the front's two launches in ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = {"snake": 0.0, "gemm": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "edm::" in e.key:
            part = "snake" if "snake_kernel" in e.key else "gemm"
            parts[part] += e.self_device_time_total / 1e3 / n
    return parts


def parent_front(checkout: Path):
    """The K2 front of another checkout, built from its decoder_block.cu into
    the build directory: ``fn(x, alpha0, w3, bias3, stride) -> y``."""
    src = checkout / "edm_tts_tpu_torch" / "csrc" / "decoder_block.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = ctypes.CDLL(str(build_sources([src], BUILD_DIR / f"libparent_front_{digest}.so")))
    fn = lib.edm_tconv_phase
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def front(x, alpha0, w3, bias3, stride):
        b, t, cin = x.shape
        n = w3.shape[-1]
        y = torch.empty((b, t * stride, n // stride), dtype=x.dtype, device=x.device)
        check_launch(fn(x.data_ptr(), alpha0.data_ptr(), w3.data_ptr(), bias3.data_ptr(),
                        y.data_ptr(), b, t, cin, n, torch.cuda.current_stream().cuda_stream),
                     "parent edm_tconv_phase")
        return y
    return front


def rel_l2(out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


@torch.no_grad()
def profile(cases, seed: int = 0, sweep: bool = False, parent=None) -> list[dict]:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for label, b, t, cin, cout, s in cases:
        x, a0, wt, w3, bias3, rus = block_params(b, t, cin, cout, s, gen)
        tile = block_ops.decoder_block_tile(b, t, cin, s * cout, s, sms)
        ref = block_ops.tconv_phase_reference(x, a0, w3, bias3).reshape(b, t * s, cout)

        def front(tile=tile):
            return block_ops.tconv_phase(x, a0, w3, bias3, s, tile=tile)

        rel = rel_l2(front(), ref)
        if not rel <= 2.0 ** -6:
            raise SystemExit(f"profile_decoder_block: {label}: the front is off its plain "
                             f"version, rel l2 {rel}")
        row = dict(case=label, b=b, t=t, cin=cin, cout=cout, stride=s, tile=tile, rel_l2=rel)
        if parent is not None:
            prel = rel_l2(parent(x, a0, w3, bias3, s), ref)
            times = [median_ms(lambda: parent(x, a0, w3, bias3, s)), median_ms(front),
                     median_ms(front), median_ms(lambda: parent(x, a0, w3, bias3, s))]
            row.update(parent_ms=statistics.mean(times[::3]), parent_rel_l2=prel,
                       front_ms_beside_parent=statistics.mean(times[1:3]), order_ms=times)
        row["front_ms"] = median_ms(front)
        row["front_parts_ms"] = front_parts(front)
        y = front()
        row["units_ms"] = [median_ms(lambda d=d, p=p: fused_residual_unit(y, *p, d))
                           for d, p in zip(block_ops.DILATIONS, rus)]
        row["block_ms"] = median_ms(lambda: block_ops.fused_decoder_block(x, a0, w3, bias3, rus, s))
        # cuDNN's transposed conv on the snake'd input, channels first
        sx = block_ops.snake(x, a0).transpose(1, 2).contiguous()
        wct = wt.permute(1, 2, 0).contiguous()  # (C_in, C_out, 2s)
        bt = bias3[:cout].bfloat16()
        lib_out = F.conv_transpose1d(sx, wct, bt, stride=s, padding=s // 2)
        row["cudnn_rel_l2"] = rel_l2(lib_out.transpose(1, 2), ref)
        row["cudnn_ms"] = median_ms(
            lambda: F.conv_transpose1d(sx, wct, bt, stride=s, padding=s // 2))
        row["front_bound_ms"], row["front_bound_by"] = bound(*front_work(b, t, cin, cout, s))
        row["unit_bound_ms"], _ = bound(*resunit_work(b, t * s, cout))
        if sweep:
            row["sweep_ms"] = {}
            for bn in block_ops.DECODER_BLOCK_TILES:
                r = rel_l2(front(bn), ref)
                row["sweep_ms"][bn] = median_ms(lambda bn=bn: front(bn)) if r <= 2.0 ** -6 else None
                print(f"K2 {label} front at tile {bn}: "
                      f"{row['sweep_ms'][bn]} ms, rel l2 {r:.3g}", flush=True)
        rows.append(row)
        parts = row["front_parts_ms"]
        print(f"K2 {label}: front {row['front_ms']:.4f} ms at tile {tile} (snake "
              f"{parts['snake']:.4f}, product {parts['gemm']:.4f}), bound "
              f"{row['front_bound_ms']:.4f} ({row['front_bound_by']}), front / bound "
              f"{row['front_ms'] / row['front_bound_ms']:.2f}, rel l2 {rel:.3g}; "
              + (f"parent front {row['parent_ms']:.4f} ms (this {row['front_ms_beside_parent']:.4f}"
                 f" beside it, order {[round(v, 4) for v in row['order_ms']]}); "
                 if parent is not None else "")
              + f"units {' / '.join(f'{v:.4f}' for v in row['units_ms'])} ms (bound "
              f"{row['unit_bound_ms']:.4f} each); block {row['block_ms']:.4f} ms; cuDNN "
              f"conv_transpose1d {row['cudnn_ms']:.4f} ms (rel l2 {row['cudnn_rel_l2']:.3g}, "
              f"front / cuDNN {row['front_ms'] / row['cudnn_ms']:.3f})", flush=True)
        del x, y, sx, ref, lib_out
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", action="store_true", help="time every column tile")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout whose K2 front to time beside this one")
    parser.add_argument("--out", type=Path, default=None, help="JSON file for the rows")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decoder_block: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    parent = None if args.parent is None else parent_front(args.parent)
    rows = profile(CASES, args.seed, args.sweep, parent)
    total = {k: sum(r[k] for r in rows) for k in ("front_ms", "front_bound_ms", "block_ms",
                                                  "cudnn_ms")}
    print(f"sum over the {len(rows)} cases: front {total['front_ms']:.4f} ms (snake "
          f"{sum(r['front_parts_ms']['snake'] for r in rows):.4f}), bound "
          f"{total['front_bound_ms']:.4f} ms, block {total['block_ms']:.4f} ms, cuDNN "
          f"conv_transpose1d {total['cudnn_ms']:.4f} ms"
          + (f", parent front {sum(r['parent_ms'] for r in rows):.4f} ms"
             if parent is not None else "") + f" ({smi})", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(device=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
