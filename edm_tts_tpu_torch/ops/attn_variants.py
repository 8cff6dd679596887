"""The attention-variant ablation: kernel K6 (csrc/attn_variants.cu) and its
plain versions.

Port of scripts/profile_attn_variants.py (``make_kernel``, ``attn``): one
unmasked bidirectional attention over ``(B, T, H, D)`` per variant, with
``s = Q K^T * D^-1/2`` in f32:

- ``full``: ``p = exp(s - rowmax)``, ``o = (p @ V) / sum(p)``;
- ``noexp``: ``p = s - rowmax``, ``o = (p @ V) / (sum(p) + 1e6)``;
- ``nosoftmax``: ``o = s @ V``;
- ``bf16exp``: ``p = exp((s - rowmax).bf16)`` in bf16, ``o = (p @ V) /
  sum(p)`` with the sum in f32.

``p`` is cast to V's dtype before its product, as the Pallas kernel casts
it. A CUDA tensor goes to K6 (bf16 only, ``D <= 64``), a CPU tensor to the
plain version; ``block_q`` (64 or 128 query rows per block) is K6's
launch parameter, the counterpart of the Pallas ``block_q``.
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.kernels import launches
from edm_tts_tpu_torch.kernels.build import check_launch, library

VARIANTS = ("full", "noexp", "nosoftmax", "bf16exp")
BLOCK_Q = (64, 128)


def attn_variant_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           variant: str = "full") -> torch.Tensor:
    """The variant as the table above says, literally: the CPU path and
    K6's oracle."""
    if variant not in VARIANTS:
        raise ValueError(f"attn_variant: unknown variant {variant!r}; one of {VARIANTS}")
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * q.shape[-1] ** -0.5
    if variant == "nosoftmax":
        p, denom = s, 1.0
    else:
        m = s.amax(dim=-1, keepdim=True)
        if variant == "noexp":
            p = s - m
            denom = p.sum(dim=-1, keepdim=True) + 1e6
        elif variant == "bf16exp":
            p = torch.exp((s - m).to(torch.bfloat16))
            denom = p.float().sum(dim=-1, keepdim=True)
        else:
            p = torch.exp(s - m)
            denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhij,bjhd->bhid", p.to(v.dtype).float(), v.float()) / denom
    return o.transpose(1, 2).to(q.dtype)


def attn_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 variant: str = "full", block_q: int = 64) -> torch.Tensor:
    """One variant through K6 on the card, the plain version on the CPU.

    On CUDA: q, k, v contiguous bf16 of one shape ``(B, T, H, D)`` with
    ``D <= 64``; anything else raises.
    """
    if variant not in VARIANTS:
        raise ValueError(f"attn_variant: unknown variant {variant!r}; one of {VARIANTS}")
    if block_q not in BLOCK_Q:
        raise ValueError(f"attn_variant: block_q must be one of {BLOCK_Q}, not {block_q}")
    if not q.is_cuda:
        return attn_variant_reference(q, k, v, variant=variant)
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"attn_variant: q, k, v must be contiguous bf16 on {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] > 64:
        raise ValueError(f"attn_variant: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} must be one (B, T, H, D) with D <= 64")
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    err = library().edm_attn_variant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h, d,
        VARIANTS.index(variant), block_q, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "attn_variant")
    launches["attn_variants"] += 1
    return out
