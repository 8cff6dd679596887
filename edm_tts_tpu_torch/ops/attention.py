"""Multi-head attention: kernels K3 (csrc/attention.cu) and K4
(csrc/attention_bwd.cu) with their f32 kernels, their plain versions and the autograd Function
that joins them.

Port of edm_tts_tpu/ops/attention.py (``mha``, ``mha_reference``) and
edm_tts_tpu/ops/pallas_attention.py (``flash_mha``, ``flash_mha_bwd``,
``flash_mha_diff``). Layout ``(B, T, H, D)``; the key-padding mask is bool
``(B, T_k)``, True = attend. The LSE is f32 ``(B*H, T_q)`` (the JAX
package's ``(B*H, T_q, 1)`` without the trailing 1).

A CUDA tensor always goes to the kernels (the JAX package's ``B*T >= 4096``
switch was a TPU v5e measurement and is not carried over); a CPU tensor
goes to the plain versions. A batch row whose mask holds no valid key
attends uniformly to every key (scores 0), in the kernels and the plain
versions alike.

The kernels copy 64-row tiles with the card's tensor-memory accelerator,
whose rows are whole 16-byte units: they take D % 8 == 0. For any other D
the wrappers pad q, k, v (and o, dO) with zeros to the next multiple of 8,
scale the scores by the true D and slice the outputs (``padded_depth``,
``pad_depth``); zero lanes change no score and no output lane that is kept.
K3's query tile (64 or 128 rows per block) is ``attention_query_tile``,
or the caller's ``block_q``.

f32 q, k, v on the card go to K3's and K4's f32 kernels
(csrc/attention_f32.cu: f32 products on the FMA units; csrc/attention_bwd_f32.cu:
products to f32 accuracy as three TF32 products of split operands on the
tensor cores; f32 outputs, as the Pallas kernels keep the input dtype);
they take D % 4 == 0 (the wrappers zero-pad other D; K4-f32 pads to a
multiple of 8 inside, by the copy engine's zero fill). ``FlashMHA`` joins
them as it joins the bf16 pair, so f32 training differentiates f32
attention on the card as the JAX trainers do with ``bf16: false``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from edm_tts_tpu_torch.kernels import H100_SMS, f32_launches, launches, sm_count
from edm_tts_tpu_torch.kernels.build import check_launch, library

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# K3's query tiles (rows per block); the Pallas kernel's block_q takes
# other sizes, which K3 does not have
QUERY_TILES = (64, 128)


def attention_query_tile(b: int, h: int, tq: int, sms: int = H100_SMS,
                         block_q: int | None = None) -> int:
    """Query rows per block of K3 for a (B, Tq, H) launch: ``block_q`` when
    given (64 or 128, else ValueError); otherwise 128 (8 warps share each
    K/V tile) when the 128-row grid, B * H * ceil(Tq / 128) blocks, still
    puts two blocks on every SM, and 64 below that, so a small batch (one
    request: B1 T604 H8 is 80 blocks at 64 rows) is not left with half the
    card idle."""
    if block_q is not None:
        if block_q not in QUERY_TILES:
            raise ValueError(f"flash_mha: block_q must be one of {QUERY_TILES} or None, "
                             f"got {block_q}")
        return block_q
    return 128 if b * h * -(-tq // 128) >= 2 * sms else 64


def padded_depth(d: int) -> int:
    """The head depth the kernels take: ``d`` rounded up to a multiple of 8."""
    return -(-d // 8) * 8


def pad_depth(x: torch.Tensor, depth: int) -> torch.Tensor:
    """``x`` with its last dimension zero-padded to ``depth``."""
    return x if x.shape[-1] == depth else F.pad(x, (0, depth - x.shape[-1]))


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain einsum-softmax attention: the CPU path and K3's oracle.
    ``scale`` defaults to ``D ** -0.5``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    sim = torch.einsum("bihd,bjhd->bhij", q, k) * scale
    if mask is not None:
        sim = torch.where(mask[:, None, None, :], sim, NEG_INF)
    attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhij,bjhd->bihd", attn, v)


def _key_valid(mask: torch.Tensor | None, b: int, tk: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys that count ``(B, T_k)``, score scale per batch row ``(B,)``):
    a row with no valid key counts every key with scale 0."""
    if mask is None:
        return torch.ones(b, tk, dtype=torch.bool, device=device), torch.ones(b, device=device)
    any_valid = mask.any(dim=-1)
    return mask | ~any_valid[:, None], any_valid.float()


def _scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor | None,
            scale: float | None = None):
    """f32 scaled scores ``(B, H, T_q, T_k)`` with the keys that count and
    the per-row scale, as the kernels form them."""
    b, _, _, d = q.shape
    valid, row_scale = _key_valid(mask, b, k.shape[1], q.device)
    sc = row_scale * (d ** -0.5 if scale is None else scale)
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * sc[:, None, None, None]
    return s, valid[:, None, None, :], sc


def attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, *, mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Log-sum-exp of the scaled, masked scores per query row, f32
    ``(B*H, T_q)``: the plain version of K3's LSE output."""
    s, valid, _ = _scores(q, k, mask, scale)
    lse = torch.logsumexp(torch.where(valid, s, -torch.inf), dim=-1)
    return lse.reshape(-1, q.shape[1])


def flash_mha_bwd_reference(q, k, v, mask, o, lse, g, *, scale: float | None = None):
    """Plain version of K4: ``(dq, dk, dv)`` from the LSE, as torch ops.

    The same arithmetic as the kernel: ``p = exp(s - lse)`` with keys that
    do not count exactly 0, ``dv = p^T dO``, ``ds = p (dO V^T - delta)
    d^-1/2`` with ``delta = rowsum(dO * O)``, ``dq = ds K``, ``dk = ds^T Q``;
    products in f32, ``p`` and ``ds`` rounded to the inputs' dtype before
    their products, as the kernel rounds them to bf16. K4's oracle on the
    card and the CPU path of ``flash_mha_bwd``. ``scale`` defaults to
    ``D ** -0.5``.
    """
    b, tq, h, _ = q.shape
    dtype = q.dtype
    s, valid, sc = _scores(q, k, mask, scale)
    p = torch.where(valid, torch.exp(s - lse.reshape(b, h, tq, 1)), 0.0)
    gf = g.float()
    delta = (gf * o.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, T_q, 1)
    dv = torch.einsum("bhij,bihd->bjhd", p.to(dtype).float(), gf)
    dp = torch.einsum("bihd,bjhd->bhij", gf, v.float())
    ds = (p * (dp - delta) * sc[:, None, None, None]).to(dtype).float()
    dq = torch.einsum("bhij,bjhd->bihd", ds, k.float())
    dk = torch.einsum("bhij,bihd->bjhd", ds, q.float())
    return dq.to(dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               *rows: torch.Tensor) -> None:
    """q/k/v (and ``rows``: o, dO, shaped like q) contiguous bf16, D <= 64."""
    b, tq, h, d = q.shape
    for t in (q, k, v, *rows):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: q, k, v (and o, dO) must be contiguous bf16 on {q.device}")
    if (k.shape != (b, k.shape[1], h, d) or v.shape != k.shape or d > 64
            or any(t.shape != q.shape for t in rows)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (need matching B, H, D <= 64)")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied if its data does not start on 16 bytes (a tensor
    map's base must)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _mask_ptr(name: str, mask: torch.Tensor | None, b: int, tk: int, device):
    if mask is None:
        return None, None
    if mask.shape != (b, tk) or mask.dtype != torch.bool or mask.device != device:
        raise ValueError(f"{name}: mask must be bool ({b}, {tk}) on {device}")
    mask = mask.contiguous()
    return mask, mask.data_ptr()


def flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mask: torch.Tensor | None = None,
    block_q: int | None = None, return_lse: bool = False,
):
    """Attention through K3 on the card, ``mha_reference`` on the CPU.

    On CUDA: q/k/v bf16 or f32 (K3's f32 kernel, output f32) contiguous
    ``(B, T, H, D)`` with ``D <= 64``; ``block_q`` is K3's bf16 tile. With
    ``return_lse`` also returns the f32 ``(B*H, T_q)`` LSE. The output is
    not attached to autograd; ``mha`` is the differentiable entry point.
    K3 takes ``attention_query_tile``'s query rows per block for this card;
    ``block_q`` (64 or 128) forces one, any other value raises. The CPU
    path computes the same function at any tile and ignores it.
    """
    if not q.is_cuda:
        out = mha_reference(q, k, v, mask=mask)
        return (out, attention_lse_reference(q, k, mask=mask)) if return_lse else out
    if q.dtype == torch.float32:
        return _flash_mha_f32(q, k, v, mask, return_lse)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check_qkv("flash_mha", q, k, v)
    mask, mask_ptr = _mask_ptr("flash_mha", mask, b, tk, q.device)
    block_q = attention_query_tile(b, h, tq, sm_count(q.device.index or 0), block_q)
    dp = padded_depth(d)
    q, k, v = (_aligned(pad_depth(x, dp)) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device) if return_lse else None
    err = library().edm_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, tq, tk, h, dp, d, block_q, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "flash_mha")
    launches["attention"] += 1
    out = out if dp == d else out[..., :d].contiguous()
    return (out, lse) if return_lse else out


def _flash_mha_f32(q, k, v, mask, return_lse: bool):
    """K3's f32 kernel: q, k, v contiguous f32 ``(B, T, H, D)``, D <= 64."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    for t in (q, k, v):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_mha: q, k, v must be contiguous f32 on {q.device}")
    if k.shape != (b, tk, h, d) or v.shape != k.shape or d > 64:
        raise ValueError(f"flash_mha: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (need matching B, H, D <= 64)")
    mask, mask_ptr = _mask_ptr("flash_mha", mask, b, tk, q.device)
    dp = -(-d // 4) * 4
    q, k, v = (_aligned(pad_depth(x, dp)) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device) if return_lse else None
    err = library().edm_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, tq, tk, h, dp, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "flash_mha")
    f32_launches["attention_f32"] += 1
    out = out if dp == d else out[..., :d].contiguous()
    return (out, lse) if return_lse else out


def flash_mha_bwd(q, k, v, mask, o, lse, g):
    """``(dq, dk, dv)`` through K4 on the card, the plain version on the CPU.

    On CUDA: q, k, v, o and ``g`` (dO) contiguous bf16 or f32 (K4's f32
    kernel, f32 gradients) ``(B, T, H, D)``, ``lse`` f32 ``(B*H, T_q)``
    from ``flash_mha(..., return_lse=True)``. ``delta = rowsum(dO * O)`` is
    one torch reduction here, outside the kernel, as the JAX package
    computes it in XLA. Both K4 kernels take lse and delta with rows padded
    to a multiple of 4 (each 64-query box they copy must start on 16 bytes).
    """
    if not q.is_cuda:
        return flash_mha_bwd_reference(q, k, v, mask, o, lse, g)
    if q.dtype == torch.float32:
        return _flash_mha_bwd_f32(q, k, v, mask, o, lse, g)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check_qkv("flash_mha_bwd", q, k, v, o, g)
    if lse.shape != (b * h, tq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_mha_bwd: lse must be contiguous f32 ({b * h}, {tq})")
    mask, mask_ptr = _mask_ptr("flash_mha_bwd", mask, b, tk, q.device)
    lse, delta = _padded_rows(lse, (g.float() * o.float()).sum(-1), b, h, tq)
    dp = padded_depth(d)
    q, k, v, g = (_aligned(pad_depth(x, dp)) for x in (q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = library().edm_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), mask_ptr, lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, tk, h, dp, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "flash_mha_bwd")
    launches["attention_bwd"] += 1
    if dp != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


def _padded_rows(lse: torch.Tensor, delta: torch.Tensor, b: int, h: int, tq: int):
    """lse ``(B*H, T_q)`` and delta ``(B, T_q, H)`` as K4 takes them: f32
    ``(B*H, ld)`` rows, ld = T_q rounded up to a multiple of 4."""
    ld = -(-tq // 4) * 4
    delta = delta.transpose(1, 2).reshape(b * h, tq)
    return tuple(_aligned(pad_depth(x, ld).contiguous()) for x in (lse, delta))


def _flash_mha_bwd_f32(q, k, v, mask, o, lse, g):
    """K4's f32 kernel: q, k, v, o, dO contiguous f32 ``(B, T, H, D)``, D <= 64."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    for t in (q, k, v, o, g):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_mha_bwd: q, k, v, o and dO must be contiguous f32 on "
                             f"{q.device}")
    if (k.shape != (b, tk, h, d) or v.shape != k.shape or d > 64 or o.shape != q.shape
            or g.shape != q.shape):
        raise ValueError(f"flash_mha_bwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (need matching B, H, D <= 64)")
    if lse.shape != (b * h, tq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_mha_bwd: lse must be contiguous f32 ({b * h}, {tq})")
    mask, mask_ptr = _mask_ptr("flash_mha_bwd", mask, b, tk, q.device)
    lse, delta = _padded_rows(lse, (g * o).sum(-1), b, h, tq)
    dp = -(-d // 4) * 4
    q, k, v, g = (_aligned(pad_depth(x, dp)) for x in (q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = library().edm_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), mask_ptr, lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, tk, h, dp, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "flash_mha_bwd")
    f32_launches["attention_bwd_f32"] += 1
    if dp != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


@torch.library.custom_op("edm_tts::flash_mha_lse", mutates_args=())
def flash_mha_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_mha(..., return_lse=True)`` as one operator, so that a
    selective-checkpoint policy can name it and keep its outputs: the
    Conformer's ``"mha"`` and ``"dots"`` remat policies do, and the
    recompute in the backward then does not launch K3 again."""
    return flash_mha(q, k, v, mask=mask, return_lse=True)


class FlashMHA(torch.autograd.Function):
    """K3 with the LSE forward, K4 backward (``flash_mha_diff``), at bf16 or
    f32."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        o, lse = flash_mha_lse(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, mask, o, lse, g.to(o.dtype).contiguous())
        return dq, dk, dv, None


def mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mask: torch.Tensor | None = None,
    implementation: str = "auto",
) -> torch.Tensor:
    """The Conformer's attention (ops/attention.py::mha in the JAX package).

    On the card: the kernels of q's dtype, bf16 or f32 (K3 alone when no
    gradient is needed, else ``FlashMHA``: K3 with the LSE and K4 in the
    backward); on the CPU:
    ``mha_reference``, which autograd differentiates. ``implementation`` is
    the config field the JAX package reads; every value other than
    ``"auto"`` and ``"pallas"`` raises on the card, so no setting moves the
    card's attention off the kernels (``"xla"`` is accepted on the CPU,
    where it is the plain path anyway). ``"ring"`` is not ported.
    """
    if implementation == "ring":
        raise NotImplementedError("mha: ring (sequence-parallel) attention is not ported")
    if implementation not in ("auto", "pallas", "xla"):
        raise ValueError(f"mha: unknown implementation {implementation!r}")
    if not q.is_cuda:
        return mha_reference(q, k, v, mask=mask)
    if implementation == "xla":
        raise ValueError("mha: implementation 'xla' (the plain attention) is not run on the "
                         "card; use 'auto' or 'pallas'")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashMHA.apply(q, k, v, mask)
    return flash_mha(q, k, v, mask=mask)
