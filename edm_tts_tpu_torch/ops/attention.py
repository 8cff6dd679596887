"""Multi-head attention: kernel K3 (csrc/attention.cu) and its plain version.

Port of edm_tts_tpu/ops/attention.py (``mha``, ``mha_reference``) and
edm_tts_tpu/ops/pallas_attention.py (``flash_mha``). Layout ``(B, T, H, D)``;
the key-padding mask is bool ``(B, T_k)``, True = attend.

A CUDA tensor always goes to K3 (the JAX package's ``B*T >= 4096`` switch
was a TPU v5e measurement and is not carried over); a CPU tensor goes to
``mha_reference``.
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.kernels import launches
from edm_tts_tpu_torch.kernels.build import check_launch, library

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain einsum-softmax attention: the CPU path and K3's oracle."""
    scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bihd,bjhd->bhij", q, k) * scale
    if mask is not None:
        sim = torch.where(mask[:, None, None, :], sim, NEG_INF)
    attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhij,bjhd->bihd", attn, v)


def flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Attention through K3 on the card, ``mha_reference`` on the CPU.

    On CUDA: q/k/v bf16 contiguous ``(B, T, H, D)`` with ``D <= 64``.
    """
    if not q.is_cuda:
        return mha_reference(q, k, v, mask=mask)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_mha: {name} must be contiguous bf16 on {q.device}")
    if k.shape != (b, tk, h, d) or v.shape != k.shape or d > 64:
        raise ValueError(f"flash_mha: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (need matching B, H, D <= 64)")
    mask_ptr = None
    if mask is not None:
        if mask.shape != (b, tk) or mask.dtype != torch.bool or mask.device != q.device:
            raise ValueError(f"flash_mha: mask must be bool ({b}, {tk}) on {q.device}")
        mask = mask.contiguous()
        mask_ptr = mask.data_ptr()
    out = torch.empty_like(q)
    err = library().edm_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        b, tq, tk, h, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "flash_mha")
    launches["attention"] += 1
    return out


# The Conformer's entry point (ops/attention.py::mha in the JAX package).
mha = flash_mha
