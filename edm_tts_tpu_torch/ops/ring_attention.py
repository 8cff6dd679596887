"""Ring attention: sequence-parallel multi-head attention (port of
edm_tts_tpu/ops/ring_attention.py).

The sequence is split over the ranks of a ``sequence`` group. Each rank
keeps its block of queries and passes its key/value block (and its key
mask) round the ring with ``batch_isend_irecv``, one neighbour step per
block, so no rank holds the whole K/V or the (T, T) scores.

- **Forward.** Each step runs kernel K3 with its LSE (``flash_mha(...,
  return_lse=True)``) on the block it holds; the blocks' outputs are merged
  in f32 by their LSEs (``merge``).
- **Backward** (``RingMHA``). Each step runs kernel K4 (``flash_mha_bwd``)
  on the block it holds with the *merged* output and LSE, so ``p = exp(s -
  lse)`` and ``delta = rowsum(dO * O)`` are those of the whole row; dq
  accumulates on its rank, dk and dv travel round the ring with their block
  and arrive back at its owner.

On CPU tensors ``flash_mha`` and ``flash_mha_bwd`` are their plain versions
(``mha_reference`` with ``attention_lse_reference``,
``flash_mha_bwd_reference``), so the same ring is the CPU path.

Masks follow ``mha_reference``: True = attend, and a batch row with no
valid key anywhere attends uniformly to every key (JAX's ring: all scores
``NEG_INF``). The kernels give a block with no valid key for a row uniform
attention over that block; a block is therefore weighted 0 for a row that
has a valid key elsewhere (``block_attention``), and its K4 gradients for
that row are 0. A sequence padded to a multiple of the ring (``t_real``
real keys) keeps uniform rows uniform over the real keys only.

``sequence_parallel_mha`` is the Conformer's use (``mha(...,
implementation="ring")`` with the ambient mesh's ``sequence`` group): every
rank holds the whole sequence's activations, slices its T/n of q, k and v,
runs the ring and all-gathers the outputs; the gradients of the slices are
all-gathered back, so the ranks of a ring compute the same gradients.
``chunked_mha`` / ``chunked_mha_bwd`` run the same steps over chunks of one
device's K/V (what the ring computes on all its ranks together), which is
how the merge is held against whole-sequence K3/K4 on one card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from edm_tts_tpu_torch.ops.attention import flash_mha, flash_mha_bwd


def block_attention(q, k, v, mask, row_has_key, real_keys: int | None = None, *,
                    attend=flash_mha):
    """One ring step: ``(o, lse)`` of q against one key block, the LSE
    ``(B, H, Tq)`` f32 with the weight the merge must give the block.

    ``row_has_key`` ``(B,)`` bool: the row has a valid key in some block.
    Where it does and this block has none, the LSE is -inf. Where it has
    none anywhere the block's keys count uniformly; ``real_keys`` (< Tk)
    says how many of this block's keys are real (the rest pad the sequence
    to the ring; their V is zero), and the uniform rows then cover only
    those."""
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    o, lse = attend(q, k, v, mask=mask, return_lse=True)
    lse = lse.view(b, h, tq)
    if mask is not None:
        dead = row_has_key & ~mask.any(-1)
        lse = lse.masked_fill(dead[:, None, None], -math.inf)
    if real_keys is not None and real_keys < tk:
        uniform = ~row_has_key
        if real_keys == 0:
            lse = lse.masked_fill(uniform[:, None, None], -math.inf)
        else:
            o = torch.where(uniform[:, None, None, None], o.float() * (tk / real_keys), o.float())
            lse = torch.where(uniform[:, None, None], math.log(real_keys), lse)
    return o, lse


def merge(o, lse, o_blk, lse_blk):
    """Merge a block's ``(o_blk, lse_blk)`` into the running f32 ``(o, lse)``
    (``(B, T, H, D)``, ``(B, H, T)``); -inf LSEs weigh 0 and give no NaN."""
    new = torch.logaddexp(lse, lse_blk)
    safe = torch.where(torch.isinf(new), 0.0, new)
    a = torch.exp(lse - safe).transpose(1, 2)[..., None]
    c = torch.exp(lse_blk - safe).transpose(1, 2)[..., None]
    return o * a + o_blk.float() * c, new


def block_grads(q, k, v, mask, o, lse, g, row_has_key, *, grads=flash_mha_bwd):
    """One ring step of the backward: K4's ``(dq, dk, dv)`` for one key block
    from the merged ``o`` and ``lse`` ``(B, H, Tq)``, 0 for rows the block
    does not count for."""
    b, tq, h, _ = q.shape
    dq, dk, dv = grads(q, k, v, mask, o, lse.reshape(b * h, tq).contiguous(), g)
    if mask is not None:  # the rows the block counts 0 for (``block_attention``)
        keep = ~(row_has_key & ~mask.any(-1))[:, None, None, None]
        dq, dk, dv = (torch.where(keep, x, 0.0) for x in (dq, dk, dv))
    return dq, dk, dv


def _real_keys(t_real: int | None, j: int, tk: int) -> int | None:
    return None if t_real is None else min(max(t_real - j * tk, 0), tk)


# -- the ring ---------------------------------------------------------------
def _neighbours(group) -> tuple[int, int]:
    """Global ranks of the next and the previous rank of ``group``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    return ranks[(r + 1) % n], ranks[(r - 1) % n]


def _rotate(tensors, group):
    """Send ``tensors`` to the next rank of the ring and receive the
    previous rank's; returns the pending work and the receive buffers."""
    nxt, prv = _neighbours(group)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    return dist.batch_isend_irecv(ops), recv


def _wait(works):
    for w in works:
        w.wait()


def _kv_mask(mask):
    """The key mask as it travels (uint8; bool is not a type every backend sends)."""
    return None if mask is None else mask.to(torch.uint8)


def _ring_forward(q, k, v, mask, group, row_has_key, t_real):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, tq, h, d = q.shape
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, tq), -math.inf, dtype=torch.float32, device=q.device)
    held = [k, v] + ([] if mask is None else [_kv_mask(mask)])
    for s in range(n):
        pending = _rotate(held, group) if s < n - 1 else None
        kb, vb = held[0], held[1]
        mb = None if mask is None else held[2].bool()
        o_blk, lse_blk = block_attention(q, kb, vb, mb, row_has_key,
                                         _real_keys(t_real, (r - s) % n, k.shape[1]))
        o, lse = merge(o, lse, o_blk, lse_blk)
        if pending is not None:
            _wait(pending[0])
            held = pending[1]
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, mask, o, lse, g, group, row_has_key):
    n = dist.get_world_size(group)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    held = [k, v] + ([] if mask is None else [_kv_mask(mask)])
    for s in range(n):
        mb = None if mask is None else held[2].bool()
        dq_b, dk_b, dv_b = block_grads(q, held[0], held[1], mb, o, lse, g, row_has_key)
        dq += dq_b.float()
        dk += dk_b.float()
        dv += dv_b.float()
        if n == 1:
            break
        # the block's dk/dv go on with it; after n moves they are home
        works, recv = _rotate((held if s < n - 1 else []) + [dk, dv], group)
        _wait(works)
        if s < n - 1:
            held, (dk, dv) = recv[:-2], recv[-2:]
        else:
            dk, dv = recv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _row_has_key(mask, group, b: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones(b, dtype=torch.bool, device=device)
    any_valid = mask.any(-1).to(torch.int32)
    dist.all_reduce(any_valid, op=dist.ReduceOp.MAX, group=group)
    return any_valid.bool()


class RingMHA(torch.autograd.Function):
    """Ring attention over ``group`` on each rank's blocks ``(B, T/n, H, D)``
    (and key mask ``(B, T/n)``): K3 with LSE per block forward, K4 per block
    backward. ``t_real``: the real length when the sequence is padded to
    the ring (None: no padding)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, t_real):
        row_has_key = _row_has_key(mask, group, q.shape[0], q.device)
        o, lse = _ring_forward(q, k, v, mask, group, row_has_key, t_real)
        ctx.group = group
        ctx.save_for_backward(q, k, v, mask, o, lse, row_has_key)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, o, lse, row_has_key = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, mask, o, lse, g.to(o.dtype).contiguous(),
                                    ctx.group, row_has_key)
        return dq, dk, dv, None, None, None


def ring_mha(q, k, v, *, group, mask=None, t_real: int | None = None):
    """Sequence-parallel bidirectional MHA on this rank's blocks: q, k, v
    ``(B, T/n, H, D)``, ``mask`` ``(B, T/n)`` bool (True = attend), the
    ring being ``group``'s ranks in order. Returns this rank's block of the
    output."""
    return RingMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask, group, t_real)


# -- the Conformer's use: whole activations, the attention on the ring ------
class _Slice(torch.autograd.Function):
    """This rank's block of dim 1; the gradient is all-gathered back."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group = group
        return x.chunk(n, dim=1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group), None


class _Gather(torch.autograd.Function):
    """Every rank's block of dim 1, in ring order; the gradient is this
    rank's block (every rank computes the same downstream)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=1)[r].contiguous(), None


def _gather(x, group):
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.cat(out, dim=1)


def _pad_to_ring(xs, mask, n: int):
    """``xs`` ``(B, T, ...)`` padded with zeros along T to a multiple of
    ``n``, the key mask with the padding never counting; returns ``(xs,
    mask, t_real)``, ``t_real`` None when nothing was padded."""
    b, t = xs[0].shape[:2]
    tp = -(-t // n) * n
    if tp == t:
        return xs, mask, None
    xs = [F.pad(x, (0, 0, 0, 0, 0, tp - t)) for x in xs]
    mask = torch.ones(b, t, dtype=torch.bool, device=xs[0].device) if mask is None else mask
    return xs, F.pad(mask, (0, tp - t), value=False), t


def sequence_parallel_mha(q, k, v, *, group, mask=None):
    """``mha`` of whole-sequence q, k, v ``(B, T, H, D)`` (the same on every
    rank of ``group``) computed on the ring: each rank attends with its T/n
    queries, and the outputs are all-gathered. T is padded to a multiple of
    the ring with keys that never count."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    t = q.shape[1]
    (q, k, v), mask, t_real = _pad_to_ring((q, k, v), mask, n)
    blk = q.shape[1] // n
    local = [_Slice.apply(x, group) for x in (q, k, v)]
    mask_l = None if mask is None else mask[:, r * blk:(r + 1) * blk].contiguous()
    out = _Gather.apply(RingMHA.apply(*local, mask_l, group, t_real), group)
    return out[:, :t]


# -- the same steps on one device --------------------------------------------
def _key_chunks(q, k, v, mask, n: int):
    """The ring's key blocks on one device: ``(row_has_key, [(k_j, v_j, mask_j,
    real keys of j)])`` with T padded to a multiple of ``n``."""
    (k, v), mask, t_real = _pad_to_ring((k, v), mask, n)
    row_has_key = (torch.ones(q.shape[0], dtype=torch.bool, device=q.device) if mask is None
                   else mask.any(-1))
    blk = k.shape[1] // n
    chunks = []
    for j in range(n):
        sl = slice(j * blk, (j + 1) * blk)
        chunks.append((k[:, sl].contiguous(), v[:, sl].contiguous(),
                       None if mask is None else mask[:, sl].contiguous(),
                       _real_keys(t_real, j, blk)))
    return row_has_key, chunks


def chunked_mha(q, k, v, mask, n: int, *, attend=flash_mha):
    """The ring's forward on one device: q against ``n`` key chunks (T padded
    to a multiple of ``n``), merged by their LSEs. Returns ``(o, lse)``, o in
    q's dtype and lse f32 ``(B, H, T)``."""
    b, t, h, d = q.shape
    row_has_key, chunks = _key_chunks(q, k, v, mask, n)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t), -math.inf, dtype=torch.float32, device=q.device)
    for kb, vb, mb, real in chunks:
        o, lse = merge(o, lse, *block_attention(q, kb, vb, mb, row_has_key, real,
                                                attend=attend))
    return o.to(q.dtype), lse


def chunked_mha_bwd(q, k, v, mask, o, lse, g, n: int, *, grads=flash_mha_bwd):
    """The ring's backward on one device: K4 on each of ``n`` key chunks with
    the merged ``o`` and ``lse`` (from ``chunked_mha``); dq summed over the
    chunks in f32."""
    t = q.shape[1]
    row_has_key, chunks = _key_chunks(q, k, v, mask, n)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for kb, vb, mb, _ in chunks:
        dq_b, dk_b, dv_b = block_grads(q, kb, vb, mb, o, lse, g, row_has_key, grads=grads)
        dq += dq_b.float()
        dks.append(dk_b)
        dvs.append(dv_b)
    return dq.to(q.dtype), torch.cat(dks, 1)[:, :t], torch.cat(dvs, 1)[:, :t]
