"""Megatron tensor parallelism of the Conformer blocks (port of
``_tp_spec_for`` / ``param_shardings`` in edm_tts_tpu/parallel/mesh.py).

The JAX package's rules, by parameter name within a block, on the port's
names:

- column-parallel (output dim split over the ``model`` ranks): ``to_q``,
  ``to_kv``, each feed-forward's first linear and the conv module's
  ``pw_in`` (``conv.net.2``);
- row-parallel (input dim split; the partial products are all-reduced,
  then the bias is added once): ``to_out``, each feed-forward's second
  linear and ``pw_out`` (``conv.net.7``);
- channel-sharded: the depthwise conv (``conv.net.4``) and the
  ``ChanLayerNorm`` scale between them, whose mean and variance are
  all-reduced over the model ranks.

``tensor_parallel(model, mesh)`` narrows every ``ConformerBlock`` of
``model`` in place, so the blocks' own forwards run on this rank's shards:
the split parameters are replaced by their shards (the names stay),
``Attention.heads`` becomes the local count (K3 and K4 run unchanged on the
local heads), the row-parallel layers become ``_RowLinear`` /
``_RowPointwise`` (reduce, then the bias) and ``ChanLayerNorm`` becomes
``TPChanLayerNorm``. ``to_kv`` and ``pw_in`` are split half by half (k and
v, value and gate), so each rank's ``chunk(2)`` gives matching halves.
A forward pre-hook puts Megatron's identity-forward, all-reduce-backward
function where the replicated input enters each sublayer's column-parallel
products, so every replicated parameter gets the same, whole gradient on
every model rank. The feed-forwards' dropout of their split hidden units
draws the whole width's mask and keeps its columns (``FeedForward.shard``),
so the draws are those of one process; ``return_attn`` maps are gathered
over the heads. It returns the ``TensorParallelPlan`` that shards and
gathers whole tensors by name (for checkpoints and ZeRO-2's norm).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from edm_tts_tpu_torch.models.conformer.conformer import ChanLayerNorm, ConformerBlock, _Pointwise
from edm_tts_tpu_torch.parallel.mesh import MODEL_AXIS, sum_parts

# name within a block -> (split dim, halves split separately)
BLOCK_RULES: dict[str, tuple[int, int]] = {
    "attn.fn.to_q.weight": (0, 1),
    "attn.fn.to_kv.weight": (0, 2),
    "attn.fn.to_out.weight": (1, 1),
    "conv.net.2.weight": (0, 2),
    "conv.net.2.bias": (0, 2),
    "conv.net.4.conv.weight": (0, 1),
    "conv.net.4.conv.bias": (0, 1),
    "conv.net.6.weight": (1, 1),
    "conv.net.7.weight": (1, 1),
    **{f"{ff}.fn.fn.net.{name}": rule for ff in ("ff1", "ff2") for name, rule in (
        ("0.weight", (0, 1)), ("0.bias", (0, 1)), ("3.weight", (1, 1)))},
}


def shard_tensor(full: torch.Tensor, dim: int, parts: int, index: int, n: int) -> torch.Tensor:
    """Rank ``index``'s shard of ``full``: each of its ``parts`` halves split
    ``n`` ways along ``dim``, this rank's pieces concatenated."""
    return torch.cat([p.chunk(n, dim)[index] for p in full.chunk(parts, dim)], dim)


def unshard_tensor(locals_: list[torch.Tensor], dim: int, parts: int) -> torch.Tensor:
    """The whole tensor from every rank's shard (``shard_tensor``'s inverse)."""
    pieces = [x.chunk(parts, dim) for x in locals_]
    return torch.cat([torch.cat([p[i] for p in pieces], dim) for i in range(parts)], dim)


# -- Megatron's autograd pair (the reduce half is mesh.sum_parts) -------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverModel(torch.autograd.Function):
    """A sum of per-rank parts used by every rank's own part downstream:
    all-reduced forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _RowParallel:
    """The row-parallel product: this rank's partial product all-reduced over
    the model ranks, then the bias."""

    group = None

    def forward(self, x):
        y = F.linear(x, self.weight.reshape(self.weight.shape[0], -1))
        return sum_parts(y, self.group) + self.bias


class _RowLinear(_RowParallel, nn.Linear):
    pass


class _RowPointwise(_RowParallel, _Pointwise):
    pass


class TPChanLayerNorm(ChanLayerNorm):
    """``ChanLayerNorm`` over channels split across the model ranks: the
    mean and the variance are sums all-reduced over them."""

    def __init__(self, dim: int, full_dim: int, group, **kw):
        super().__init__(dim, **kw)
        self.full_dim, self.group = full_dim, group

    def forward(self, x):
        xf = x.float()
        mean = _SumOverModel.apply(xf.sum(dim=-1, keepdim=True), self.group) / self.full_dim
        var = _SumOverModel.apply((xf - mean).square().sum(dim=-1, keepdim=True),
                                  self.group) / self.full_dim
        y = (xf - mean) * torch.rsqrt(var.clamp_min(1e-6))
        return (y * self.weight.view(-1)).to(x.dtype)


class TensorParallelPlan:
    """Which parameters are split over the model ranks, and how."""

    def __init__(self, mesh, rules: dict[str, tuple[int, int]]):
        self.group = mesh.group(MODEL_AXIS)
        self.n, self.index = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
        self.rules = rules
        self.sharded = frozenset(rules)

    def shard_state(self, state: dict) -> dict:
        """This rank's shards of a whole per-name state."""
        return {k: shard_tensor(v, *self.rules[k], self.index, self.n) if k in self.rules else v
                for k, v in state.items()}

    def gather_state(self, state: dict) -> dict:
        """The whole tensors from every model rank's shards (a collective:
        every model rank calls it with the same names)."""
        out = {}
        for k, v in state.items():
            if k not in self.rules:
                out[k] = v
                continue
            parts = [torch.empty_like(v) for _ in range(self.n)]
            dist.all_gather(parts, v.contiguous(), group=self.group)
            out[k] = unshard_tensor(parts, *self.rules[k])
        return out


# the row-parallel layers of a block, by name, and what replaces them
ROW_LAYERS = {"attn.fn.to_out": _RowLinear, "ff1.fn.fn.net.3": _RowLinear,
              "ff2.fn.fn.net.3": _RowLinear, "conv.net.7": _RowPointwise}


def _swap(block: nn.Module, name: str, new: nn.Module) -> None:
    """Put ``new`` in place of ``block``'s submodule ``name``, with its
    parameters (``new`` is built on the meta device)."""
    parent, _, child = name.rpartition(".")
    old = block.get_submodule(name)
    for pname, param in old.named_parameters(recurse=False):
        setattr(new, pname, param)
    setattr(block.get_submodule(parent), child, new)


def tensor_parallel(model: nn.Module, mesh) -> TensorParallelPlan:
    """Split every ``ConformerBlock`` of ``model`` over the mesh's model ranks
    (in place; names are kept) and return the plan."""
    group, n, index = mesh.group(MODEL_AXIS), mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)

    def copy_in(module, args):  # the replicated input of a column-parallel product
        return (_CopyToModel.apply(args[0], group),) + args[1:]

    def gather_heads(module, args, output):  # a ``return_attn`` map of the local heads
        if not isinstance(output, tuple):
            return output
        out, attn = output
        parts = [torch.empty_like(attn) for _ in range(n)]
        dist.all_gather(parts, attn.contiguous(), group=group)
        return out, torch.cat(parts, dim=1)

    rules: dict[str, tuple[int, int]] = {}
    blocks = [(name, m) for name, m in model.named_modules() if isinstance(m, ConformerBlock)]
    for prefix, block in blocks:
        attn, conv = block.attn.fn, block.conv
        ffs = [block.ff1.fn.fn, block.ff2.fn.fn]
        inner = conv.net[4].conv.out_channels
        for size, what in ((attn.heads, "heads"), (ffs[0].net[0].out_features, "hidden units"),
                           (inner, "conv channels")):
            if size % n:
                raise ValueError(f"{size} {what} do not split over {n} model ranks")
        for key, rule in BLOCK_RULES.items():
            path, _, pname = key.rpartition(".")
            module = block.get_submodule(path)
            old = getattr(module, pname)
            setattr(module, pname, nn.Parameter(shard_tensor(old.detach(), *rule, index, n),
                                                requires_grad=old.requires_grad))
        for path, cls in ROW_LAYERS.items():
            out_dim, in_dim = block.get_submodule(path).weight.shape[:2]
            row = (cls(in_dim, out_dim, device="meta") if cls is _RowLinear
                   else cls(in_dim, out_dim, 1, device="meta"))
            row.group = group
            _swap(block, path, row)
        _swap(block, "conv.net.6", TPChanLayerNorm(inner // n, inner, group, device="meta"))
        attn.heads //= n
        for module in (block.attn.fn.to_q, block.attn.fn.to_kv, ffs[0].net[0], ffs[1].net[0]):
            module.out_features = module.weight.shape[0]
        pw_in, depthwise = conv.net[2], conv.net[4].conv
        pw_in.out_channels = pw_in.weight.shape[0]
        depthwise.in_channels = depthwise.out_channels = depthwise.groups = inner // n
        attn.register_forward_pre_hook(copy_in)
        attn.register_forward_hook(gather_heads)
        for ff in ffs:
            ff.register_forward_pre_hook(copy_in)
            ff.shard = (index, n)
        pw_in.register_forward_pre_hook(copy_in)
        pre = f"{prefix}." if prefix else ""
        rules.update({pre + k: v for k, v in BLOCK_RULES.items()})
    return TensorParallelPlan(mesh, rules)
