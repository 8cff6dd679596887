"""Conformer backbone of the t2s and s2a stages (port of
edm_tts_tpu/models/conformer/conformer.py).

Block: ``x + 0.5*FF(LN x)`` -> ``x + MHSA(LN x, RoPE)`` -> ``x + Conv(x)``
-> ``x + 0.5*FF(LN x)`` -> ``LN x``. Module names follow the reference
checkpoint keys (``ff1.fn.norm``, ``attn.fn.to_q``, ``conv.net.4.conv``...),
so a reference state dict loads as it is. Things that differ from torch's
defaults and are kept from the JAX package:

- every LayerNorm has eps 1e-6 (flax's default);
- ``ChanLayerNorm`` divides by ``sqrt(max(var, 1e-6))``, not ``var + eps``;
- the GLU takes the first half as the value and the second as the gate;
- the depthwise conv pads ``(k//2, k//2 - (k+1)%2)`` and ``conv_pad_mask``
  zeroes invalid positions right before it;
- q and k/v are separate bias-free linears; ``heads * dim_head`` may differ
  from ``dim`` (the t2s model runs 8 x 24 = 192 inside a width of 384).

Attention goes through ``ops.mha``: kernel K3 on the card, and K4 in the
backward when a gradient is needed; with ``return_attn`` (per-block
attention maps) it is the JAX ``Attention``'s plain einsum instead, which
gives the map. ``Conformer.forward`` also takes ``output_layer_idx``, the
JAX package's early exit after that block. The linears and the pointwise
convs are the JAX package's ``QDense`` sites: ``models/quantize.py`` swaps
them for ``QLinear`` (kernel K5 on the card).

Dropout (the JAX package's ``train=True``) is on when a forward is given a
``dropout_generator``; its masks come from that generator. It sits where
the JAX modules put it: after the Swish and after the second linear of each
feed-forward, and at the end of the conv module. ``attn_dropout`` is
carried in the config but not applied, as the JAX ``Attention`` does not.

Gradient checkpointing (``remat``, the JAX ``nn.remat`` over each block)
applies while autograd records, through ``apply_block``; ``remat_policy``
says what a block keeps for its backward:

- ``"full"``: its input only; the backward re-runs the whole block, K3
  included;
- ``"mha"``: its input and the attention's output and LSE (the outputs of
  the ``edm_tts::flash_mha_lse`` operator); the backward re-runs the rest,
  never K3;
- ``"dots"``: that and every product without batch dimensions (``mm``,
  ``addmm``: the linears and the pointwise convs).

``torch.utils.checkpoint`` restores only the default generators' states
before a recompute; ``remat_block`` also sets the explicit dropout
generator back to where the block's forward started, so the recompute
draws the forward's dropout masks, and then leaves it where the whole
forward left it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from edm_tts_tpu_torch.ops import apply_rope, mha, rope_frequencies

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    dim: int = 512
    depth: int = 8
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    conv_expansion_factor: int = 2
    conv_kernel_size: int = 31
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    conv_dropout: float = 0.0
    attn_implementation: str = "auto"
    # "none" | "int8": set by models/quantize.py, which swaps the linears
    quantize: str = "none"
    # gradient checkpointing and its policy ("full", "mha" or "dots"; see
    # the module docstring)
    remat: bool = False
    remat_policy: str = "dots"


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``; a no-op without a generator (inference)
    or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, **kw):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.norm(x), **kwargs)


class _Scale(nn.Module):
    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.scale = scale
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(x, **kwargs) * self.scale


class FeedForward(nn.Module):
    """Linear -> Swish -> Linear; ``net.0`` and ``net.3`` as in the reference."""

    def __init__(self, dim: int, mult: int, rate: float = 0.0, **kw):
        super().__init__()
        self.rate = rate
        self.net = nn.Sequential(
            nn.Linear(dim, dim * mult, **kw), nn.SiLU(), nn.Identity(),
            nn.Linear(dim * mult, dim, **kw), nn.Identity(),
        )

    def forward(self, x, *, dropout_generator=None):
        lin1, act, _, lin2, _ = self.net
        x = dropout(act(lin1(x)), self.rate, dropout_generator)
        return dropout(lin2(x), self.rate, dropout_generator)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, implementation: str = "auto", **kw):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.implementation = implementation
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, **kw)

    def forward(self, x, *, rope=None, mask=None, return_attn=False):
        """``return_attn``: ``(out, attn)`` with the ``(B, H, T, T)`` f32 map,
        computed outside the kernels as the JAX ``Attention`` does (the
        reference's einsum fallback)."""
        b, t, _ = x.shape
        shape = (b, t, self.heads, self.dim_head)
        q = self.to_q(x).view(shape)
        k, v = (y.reshape(shape) for y in self.to_kv(x).chunk(2, dim=-1))
        if rope is not None:
            q = apply_rope(rope[:, None, :], q)
            k = apply_rope(rope[:, None, :], k)
        if not return_attn:
            out = mha(q.contiguous(), k.contiguous(), v.contiguous(), mask=mask,
                      implementation=self.implementation)
            return self.to_out(out.reshape(b, t, -1))
        sim = torch.einsum("bihd,bjhd->bhij", q, k) * self.dim_head ** -0.5
        if mask is not None:
            sim = torch.where(mask[:, None, None, :], sim, -1e9)
        attn = torch.softmax(sim.float(), dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn.to(q.dtype), v)
        return self.to_out(out.reshape(b, t, -1)), attn


class ChanLayerNorm(nn.Module):
    """Scale-only LayerNorm over channels, biased variance, weight ``(1, C, 1)``."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1, dim, 1, **kw))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var.clamp_min(1e-6))
        return (y * self.weight.view(-1)).to(x.dtype)


class _DepthWiseConv1d(nn.Module):
    def __init__(self, dim: int, kernel_size: int, **kw):
        super().__init__()
        self.padding = (kernel_size // 2, kernel_size // 2 - (kernel_size + 1) % 2)
        self.conv = nn.Conv1d(dim, dim, kernel_size, groups=dim, **kw)

    def forward(self, x):
        y = F.conv1d(F.pad(x.transpose(1, 2), self.padding), self.conv.weight,
                     self.conv.bias, groups=x.shape[-1])
        return y.transpose(1, 2)


class _Pointwise(nn.Conv1d):
    """A k=1 conv (the reference's key and ``(out, in, 1)`` weight shape)
    applied to channel-last input as a linear."""

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


class ConvModule(nn.Module):
    """LN -> pointwise (dim -> 2*inner) -> GLU -> depthwise -> Swish ->
    ChanLayerNorm -> pointwise (inner -> dim); ``net.{0,2,4,6,7}``."""

    def __init__(self, dim: int, expansion_factor: int, kernel_size: int, rate: float = 0.0,
                 **kw):
        super().__init__()
        self.rate = rate
        inner = dim * expansion_factor
        self.net = nn.ModuleList([
            nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Identity(),
            _Pointwise(dim, 2 * inner, 1, **kw), nn.Identity(),
            _DepthWiseConv1d(inner, kernel_size, **kw), nn.Identity(),
            ChanLayerNorm(inner, **kw), _Pointwise(inner, dim, 1, **kw),
        ])

    def forward(self, x, *, pad_mask=None, dropout_generator=None):
        norm, _, pw_in, _, depthwise, _, chan_norm, pw_out = self.net
        x = pw_in(norm(x))
        val, gate = x.chunk(2, dim=-1)
        x = val * torch.sigmoid(gate)
        if pad_mask is not None:
            x = torch.where(pad_mask[:, :, None], x, 0.0)
        x = depthwise(x)
        x = chan_norm(x * torch.sigmoid(x))
        return dropout(pw_out(x), self.rate, dropout_generator)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, **kw):
        super().__init__()
        c = cfg
        self.ff1 = _Scale(0.5, _PreNorm(
            c.dim, FeedForward(c.dim, c.ff_mult, c.ff_dropout, **kw), **kw))
        self.attn = _PreNorm(c.dim, Attention(c.dim, c.heads, c.dim_head,
                                              c.attn_implementation, **kw), **kw)
        self.conv = ConvModule(c.dim, c.conv_expansion_factor, c.conv_kernel_size,
                               c.conv_dropout, **kw)
        self.ff2 = _Scale(0.5, _PreNorm(
            c.dim, FeedForward(c.dim, c.ff_mult, c.ff_dropout, **kw), **kw))
        self.post_norm = nn.LayerNorm(c.dim, eps=LN_EPS, **kw)

    def forward(self, x, *, rope=None, mask=None, conv_pad_mask=None, dropout_generator=None,
                return_attn=False):
        """``return_attn``: ``(x, attn)``, the attention's map beside the output."""
        x = x + self.ff1(x, dropout_generator=dropout_generator)
        out = self.attn(x, rope=rope, mask=mask, return_attn=return_attn)
        if return_attn:
            out, weights = out
        x = x + out
        x = x + self.conv(x, pad_mask=conv_pad_mask, dropout_generator=dropout_generator)
        x = x + self.ff2(x, dropout_generator=dropout_generator)
        x = self.post_norm(x)
        return (x, weights) if return_attn else x


def _saved_ops(policy: str) -> list | None:
    """The operators whose outputs a remat policy keeps (None: only the
    block's input, ``"full"``)."""
    if policy == "full":
        return None
    attention = torch.ops.edm_tts.flash_mha_lse.default
    if policy == "mha":
        return [attention]
    if policy == "dots":
        return [attention, torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
    raise ValueError(f"unknown remat_policy: {policy!r}")


def remat_block(block: nn.Module, x: torch.Tensor, policy: str, *,
                dropout_generator: torch.Generator | None = None, **kwargs) -> torch.Tensor:
    """``block(x, **kwargs)`` under ``torch.utils.checkpoint`` with the
    policy's saved operators; the recompute in the backward starts the
    dropout generator where the forward started it and puts it back after."""
    saved = _saved_ops(policy)
    gen = dropout_generator
    start = None if gen is None else gen.get_state()
    runs = 0

    def run(x):
        nonlocal runs
        runs += 1
        if runs == 1 or gen is None:
            return block(x, dropout_generator=gen, **kwargs)
        after = gen.get_state()
        gen.set_state(start)
        try:
            return block(x, dropout_generator=gen, **kwargs)
        finally:
            gen.set_state(after)

    if saved is None:
        return checkpoint(run, x, use_reentrant=False)
    return checkpoint(run, x, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, saved))


def apply_block(block: nn.Module, x: torch.Tensor, cfg: ConformerConfig, **kwargs) -> torch.Tensor:
    """One block, under ``remat_block`` when ``cfg.remat`` and autograd
    records (the JAX package remats under ``train``; here the forward that
    builds a graph is the one that can save memory)."""
    if cfg.remat and torch.is_grad_enabled():
        return remat_block(block, x, cfg.remat_policy, **kwargs)
    return block(x, **kwargs)


class Conformer(nn.Module):
    def __init__(self, cfg: ConformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            ConformerBlock(cfg, device=device, dtype=dtype) for _ in range(cfg.depth))

    def forward(self, x, *, mask=None, conv_pad_mask=None, dropout_generator=None,
                output_layer_idx=None, return_attn=False):
        """``dropout_generator`` turns dropout on (training) and draws its
        masks; with ``cfg.remat`` each block is checkpointed while autograd
        records. ``output_layer_idx=i`` returns block i's output and runs no
        later block; ``return_attn`` returns ``(x, [each block's (B, H, T, T)
        map])`` and calls the blocks outside ``remat_block``, as the JAX
        package does."""
        rope = rope_frequencies(x.shape[-2], self.cfg.dim_head, device=x.device)
        kw = dict(rope=rope, mask=mask, conv_pad_mask=conv_pad_mask,
                  dropout_generator=dropout_generator)
        attns = [] if return_attn else None
        for i, block in enumerate(self.layers):
            if return_attn:
                x, attn = block(x, return_attn=True, **kw)
                attns.append(attn)
            else:
                x = apply_block(block, x, self.cfg, **kw)
            if i == output_layer_idx:
                break
        return (x, attns) if return_attn else x
