"""Weight-only int8 dense: kernel K5 (csrc/qdense.cu), its plain version and
the ``QLinear`` module.

Port of edm_tts_tpu/ops/qdense.py (``quantize_weight``,
``quantizable_shape``, ``int8_dense``, ``QDense``). Weights are kept in the
JAX layout ``[in, out]``: ``kernel_q`` int8 ``(K, N)`` and a per-output-
column f32 ``kernel_scale`` ``(N,)``.

``int8_dense`` computes ``(x @ W_int8) * scale`` with f32 accumulation,
cast to ``x.dtype``: kernel K5 for a CUDA tensor, ``int8_dense_reference``
(the JAX package's ``implementation="xla"`` branch) for a CPU tensor. K5
takes one of ``INT8_TILES`` per launch, ``int8_dense_tile``'s choice for
the shape and the card unless the caller forces one.
f32 activations on the card go to K5's f32 kernel (csrc/qdense_f32.cu: the
int8 weight widened on chip, products to f32 accuracy as two TF32 products
on the tensor cores, x split into hi and lo parts, and an f32 output, as
the Pallas kernel widens the weight to the activation's dtype); it takes
one of ``INT8_F32_TILES`` per launch, ``int8_dense_f32_tile``'s choice.
``implementation="w8a8"`` also quantizes the activations per row and runs
an s8 x s8 -> s32 product; it is plain PyTorch in both packages
(``torch._int_mm`` on the card, an int32 matmul on the CPU).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from edm_tts_tpu_torch.kernels import (H100_SMS, f32_launches, int8_dense_shapes, launches,
                                      refuse_grad, sm_count)
from edm_tts_tpu_torch.kernels.build import check_launch, library

MODES = ("int8", "w8a8")
# K5's compiled tiles, (output columns, x rows) per block, in the order of
# the kernel's tile index (csrc/qdense.cu, edm_int8_dense)
INT8_TILES = ((128, 256), (128, 128), (128, 64))
# most blocks (of one cluster) that split an output tile's K steps
MAX_SPLITS = 4
# The cost model of int8_dense_tile, in microseconds on a full card: a
# block's time per 64-deep K step at each tile's x rows, a fixed cost per
# wave of blocks, and the cost of each added split (fitted to
# profile_qdense's sweep of every launch at one request's and one served
# batch's shapes on an H100 SXM: its picks sum to within 4 % of the fastest
# launch of each case)
STEP_US = {256: 0.7, 128: 0.45, 64: 0.36}
WAVE_US = 8.0
SPLIT_US = 3.0


# K5's f32 kernel's tiles, (output columns, x rows) per block, in the order
# of its tile index (csrc/qdense_f32.cu, edm_int8_dense_f32), and its most
# blocks (of one cluster) per output tile
INT8_F32_TILES = ((128, 128), (128, 64))
MAX_SPLITS_F32 = 8
# The cost model of int8_dense_f32_tile, int8_dense_tile's with a block's
# time per 32-deep K step (fitted to ``profile_qdense --f32``'s sweep of
# every launch at one request's and one served batch's shapes on an H100
# SXM: its picks sum to within 1 % of the fastest launch of each case)
F32_STEP_US = {128: 0.55, 64: 0.30}
F32_WAVE_US = 12.0
F32_SPLIT_US = 0.5


def _least_cost_launch(m, k, n, sms, tiles, max_splits, k_step, step_us, wave_us, split_us):
    """The launch ``(output columns, x rows, splits)`` of least estimated
    time: a tile of ``tiles`` whose columns divide ``n`` and 1 to
    ``max_splits`` blocks per output tile (no more than the ceil(k /
    k_step) K steps); waves of blocks (one block per multiprocessor) times a
    block's K steps times ``step_us[rows]`` plus ``wave_us``, plus
    ``split_us`` per added split. A tie goes to the larger tile, then to
    fewer splits."""
    steps = -(-k // k_step)

    def cost(launch):
        bn, bm, splits = launch
        waves = -(-(n // bn * -(-m // bm) * splits) // sms)
        block = -(-steps // splits) * step_us[bm] + wave_us
        return waves * block + (splits - 1) * split_us, -bm, splits

    return min(((bn, bm, s) for bn, bm in tiles if n % bn == 0
                for s in range(1, min(max_splits, steps) + 1)), key=cost)


@functools.lru_cache(maxsize=4096)  # a served call asks for ~20 shapes 2105 times
def int8_dense_tile(m: int, k: int, n: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """K5's launch for an ``(m, k) @ (k, n)`` product on a card of ``sms``
    multiprocessors: a tile of INT8_TILES, 1 to MAX_SPLITS splits of its 64-deep
    K steps, by the cost model STEP_US, WAVE_US, SPLIT_US
    (``_least_cost_launch``)."""
    return _least_cost_launch(m, k, n, sms, INT8_TILES, MAX_SPLITS, 64, STEP_US, WAVE_US,
                              SPLIT_US)


@functools.lru_cache(maxsize=4096)
def int8_dense_f32_tile(m: int, k: int, n: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """K5's f32 launch for an ``(m, k) @ (k, n)`` product on a card of ``sms``
    multiprocessors: a tile of INT8_F32_TILES, 1 to MAX_SPLITS_F32 splits of
    its 32-deep K steps, by the cost model F32_STEP_US, F32_WAVE_US,
    F32_SPLIT_US (``_least_cost_launch``)."""
    return _least_cost_launch(m, k, n, sms, INT8_F32_TILES, MAX_SPLITS_F32, 32, F32_STEP_US,
                              F32_WAVE_US, F32_SPLIT_US)


def _check_tile(tile, tiles, max_splits: int, k_step: int, k: int, n: int):
    """``tile`` if it is (columns, rows, splits) with (columns, rows) one of
    ``tiles`` dividing N and 1 <= splits <= min(max_splits, ceil(K / k_step))."""
    most = min(max_splits, -(-k // k_step))
    if len(tile) != 3 or tuple(tile[:2]) not in tiles or n % tile[0] or not 1 <= tile[2] <= most:
        raise ValueError(f"int8_dense: tile {tile} is not (columns, rows, splits) with "
                         f"(columns, rows) one of {tiles} dividing N={n} and "
                         f"1 <= splits <= {most}")
    return tile


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(K, N)`` float weights -> (int8 ``(K, N)``, f32 per-column scale
    ``(N,)``). Symmetric, round half to even, clipped to +-127; a zero
    column gets scale 1."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantizable_shape(in_features: int, features: int) -> bool:
    """Whether ``(in, out)`` takes the int8 path (the JAX package's gate:
    the TPU kernel's int8 tile is 32 rows by 128 lanes)."""
    return in_features % 32 == 0 and features % 128 == 0


def int8_dense_reference(x: torch.Tensor, kernel_q: torch.Tensor,
                         kernel_scale: torch.Tensor) -> torch.Tensor:
    """Plain version: the CPU path and K5's oracle, f32 accumulation."""
    acc = x.float() @ kernel_q.float()
    return (acc * kernel_scale).to(x.dtype)


def _w8a8(x: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic int8 activations x int8 weights, int32 accumulation."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    xscale = torch.where(amax > 0, amax / 127.0, 1.0).float()
    xq = torch.clamp(torch.round(x.float() / xscale), -127, 127).to(torch.int8)
    if x.is_cuda:
        acc = torch._int_mm(xq, kernel_q)
    else:
        acc = xq.int() @ kernel_q.int()
    return (acc.float() * xscale * kernel_scale).to(x.dtype)


def int8_dense(x: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
               *, implementation: str = "int8",
               tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """``x @ dequant(kernel_q)``: ``(..., K)`` -> ``(..., N)`` in ``x.dtype``.

    ``implementation``: ``"int8"`` (K5 on CUDA: x bf16, or f32 through K5's
    f32 kernel, ``K % 32 == 0`` and ``N % 128 == 0``, else it raises) or
    ``"w8a8"``. K5 is inference-only:
    on CUDA it raises when autograd would need a gradient through it.
    ``tile`` forces K5's launch, ``(output columns, x rows, splits)`` with
    the first two one of ``INT8_TILES`` dividing N and 1 <= splits <=
    min(MAX_SPLITS, ceil(K / 64)) (f32 x: one of ``INT8_F32_TILES``, 1 <=
    splits <= min(MAX_SPLITS_F32, K / 32)); None takes ``int8_dense_tile``'s
    (``int8_dense_f32_tile``'s). The CPU path computes the same function at
    any tile and ignores it.
    """
    if implementation not in MODES:
        raise ValueError(f"int8_dense: unknown implementation {implementation!r}")
    k, n = kernel_q.shape
    lead = x.shape[:-1]
    xf = x.reshape(-1, k)
    if implementation == "w8a8":
        return _w8a8(xf, kernel_q, kernel_scale).reshape(*lead, n)
    if not x.is_cuda:
        return int8_dense_reference(xf, kernel_q, kernel_scale).reshape(*lead, n)
    refuse_grad("int8_dense", x, kernel_scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_dense: K5 takes bf16 or f32 activations, got {x.dtype}")
    if not quantizable_shape(k, n):
        raise ValueError(f"int8_dense: K5 needs K % 32 == 0 and N % 128 == 0, got K={k}, N={n}")
    if kernel_q.dtype != torch.int8 or kernel_scale.dtype != torch.float32 \
            or kernel_scale.shape != (n,):
        raise ValueError("int8_dense: kernel_q must be int8 (K, N) and kernel_scale f32 (N,)")
    xf = xf.contiguous()
    for name, t in (("x", xf), ("kernel_q", kernel_q), ("kernel_scale", kernel_scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_dense: {name} must be contiguous, 16-byte aligned, "
                             f"on {x.device}")
    m = xf.shape[0]
    if x.dtype == torch.float32:
        if tile is None:
            tile = int8_dense_f32_tile(m, k, n, sm_count(x.device.index or 0))
        tile = _check_tile(tile, INT8_F32_TILES, MAX_SPLITS_F32, 32, k, n)
        return _int8_dense_f32(xf, kernel_q, kernel_scale, tile).reshape(*lead, n)
    if tile is None:
        tile = int8_dense_tile(m, k, n, sm_count(x.device.index or 0))
    tile = _check_tile(tile, INT8_TILES, MAX_SPLITS, 64, k, n)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    err = library().edm_int8_dense(
        xf.data_ptr(), kernel_q.data_ptr(), kernel_scale.data_ptr(), out.data_ptr(),
        m, k, n, INT8_TILES.index(tuple(tile[:2])), tile[2],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "int8_dense")
    launches["int8_dense"] += 1
    int8_dense_shapes[(m, k, n)] += 1
    return out.reshape(*lead, n)


def _int8_dense_f32(xf: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                    tile: tuple[int, int, int]) -> torch.Tensor:
    """K5's f32 kernel on checked ``(M, K)`` f32 activations at a checked tile."""
    m, n = xf.shape[0], kernel_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xf.device)
    if m == 0:
        return out
    err = library().edm_int8_dense_f32(
        xf.data_ptr(), kernel_q.data_ptr(), kernel_scale.data_ptr(), out.data_ptr(),
        m, kernel_q.shape[0], n, INT8_F32_TILES.index(tuple(tile[:2])), tile[2],
        torch.cuda.current_stream(xf.device).cuda_stream,
    )
    check_launch(err, "int8_dense")
    f32_launches["int8_dense_f32"] += 1
    return out


class QLinear(nn.Module):
    """A quantized ``nn.Linear``: ``int8_dense(x) + bias``.

    The bias is added after the product in ``x.dtype``, as the JAX package's
    ``QDense`` does (the product is rounded to ``x.dtype`` first).
    """

    def __init__(self, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                 bias: torch.Tensor | None = None, mode: str = "int8"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"QLinear: unknown mode {mode!r}")
        self.mode = mode
        self.register_buffer("kernel_q", kernel_q.to(torch.int8).contiguous())
        self.register_buffer("kernel_scale", kernel_scale.float().contiguous())
        self.register_buffer("bias", None if bias is None else bias.detach().clone())

    @classmethod
    def from_weight(cls, weight: torch.Tensor, bias: torch.Tensor | None,
                    mode: str = "int8") -> "QLinear":
        """From a torch ``(out, in)`` weight (``nn.Linear``'s layout)."""
        q, scale = quantize_weight(weight.detach().t())
        return cls(q, scale, bias, mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_dense(x, self.kernel_q, self.kernel_scale, implementation=self.mode)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def extra_repr(self) -> str:
        k, n = self.kernel_q.shape
        return f"in_features={k}, out_features={n}, mode={self.mode}"
