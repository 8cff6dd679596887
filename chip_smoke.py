#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (edm_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. environment: torch / CUDA versions and the card's name and power limit;
  2. build: nvcc builds the kernels from edm_tts_tpu_torch/csrc;
  3. kernels: each hand-written kernel (K1 residual unit, K2 decoder block,
     K3 attention, K3 with its LSE output and K4 attention backward, K5 int8
     dense, K6 the attention-variant ablation) against its plain PyTorch
     version at the shapes of the synthesis, serving, training and ablation
     paths in bf16: relative l2 and max abs error within their limits (K3's
     LSE also within an absolute limit), planted faults of the plain version
     outside them, median times of the kernel, the plain version and, where
     one PyTorch call computes the same function, that call (for K4 the
     backward of scaled_dot_product_attention: forward and backward timed,
     the forward subtracted; for K6 SDPA's forward); the least time the card
     could take (utils/devtime.py: bytes over 3.35 TB/s, products over 989
     TFLOP/s, exponentials over 3.9e12/s, the H100 SXM's peaks);
  4. end to end: full-width models (the default codec and s2a, the t2s of
     bench.py; edm_tts_tpu_torch/profile_synthesis.py builds them) from a
     seeded random init in bf16 answer (a) a 10 s request with a given
     length on a full canvas, as bench.py runs it, and (b) a request that
     uses the length predictor and the masked canvas; checks shapes, finite
     non-silent audio, codes in range, the kernels' launch counts, and the
     decode against the plain versions; prints the wall seconds per second
     of audio of (a);
  5. served path (c): the same models with int8 weights behind TTSEngine,
     DynamicBatcher and TTSServer over HTTP on 127.0.0.1: four concurrent
     requests (one with a given length) and one long request of three
     chunks; checks the WAVs, that the batcher coalesced requests, the
     kernels' launch counts (K5 on every quantized linear, K3, K1, and no
     K2 on the masked decode), the int8 s2a's logits against the bf16 ones
     and the masked decode against exact-size decodes; prints each
     request's latency and the engine's wall per second of audio;
  6. training (d): the s2a recipe of configs/injection_conformer/
     train_config.yaml (d1024, 16 layers, B32 x 768 frames in 4
     micro-batches, bf16 autocast, f32 weights and AdamW state) through
     train.run_s2a.main_from_dict on seeded token shards and a seeded random
     init, 6 optimizer steps with a 2-step warmup; first one micro-batch's
     loss and gradient through K3+K4 against the same step on the same
     model with the Conformer's attention replaced by the plain version for
     that one call (and a planted K4 fault outside the limit); checks
     finite losses and gradient norms, the frozen codec unchanged, every
     trainable tensor moved and 16 K3 and 16 K4 launches per micro-batch;
     prints seconds per step, frames per second, peak device memory and
     the final checkpoint's size and save time;
  7. training (e): the t2s recipe of configs/text_to_semantic_w_length/
     train_config.yaml (hidden 384, 12 + 4 layers, heads 8 x 24, B32, lr
     2.5e-4, bf16 autocast) through train.run_t2s.main_from_dict on 2100
     seeded items (length-bucketed batches), 6 steps with a 2-step warmup;
     first one batch of 8 through K3+K4 against the plain attention as in
     (d); checks finite losses and gradient norms, every trainable tensor
     moved, 16 K3 and 16 K4 launches per step and at least two canvas
     lengths; prints seconds per step, canvas tokens per second and peak
     device memory;
  8. gradient checkpointing: one full-width s2a micro-batch (B8 x 768,
     dropout 0.1, a fixed generator) under the remat policies "full",
     "mha" and "dots" against none: gradients within REMAT_GRAD_REL_L2_TOL,
     32 K3 launches under "full" and 16 under the others, peak memory of
     each; then 2 steps of the s2a recipe as B32 in one micro-batch under
     "mha" (step time, peak memory);
  9. ablation (f): K6's variants and query tiles at B32 T1408 H16 D24
     through profile_attn_variants.sweep, with its launches counted.
The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
There is no CPU fallback: without a CUDA device the script fails.

    python3 chip_smoke.py --source-faults

plants each of SOURCE_FAULTS in a copy of K3's, K4's or K6's CUDA source
(the package and this script copied into a temporary directory, built
there) and runs the K3-with-LSE/K4 and ragged K6 cases of phase 3 on it
(``--attention-kernels``, which exits 3 when a case is outside its
limits); the sources as they are must pass first, and it exits 1 if any
fault passes.
"""

from __future__ import annotations

import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

SEED = 0
# Kernel against plain version: the relative l2 error ||out - ref|| / ||ref||
# must stay under REL_L2_TOL. Kernel and plain version round intermediates
# to bf16 at different points, which leaves ~0.3 % (K1, K2) to ~0.6 % (K3)
# and ~0.003 % (K5, which rounds only its output); leaving out a bias, a
# snake alpha or a scale, dropping the keys of a tail tile or the last K
# step, ignoring the mask or scaling by the padded head depth moves it by
# 8 % or more. Each case also shows, on the plain version, that the limit
# rejects such planted faults.
REL_L2_TOL = 2.0 ** -6
# and no element may be off by more than 2^-5 of the output's largest
# magnitude (4-8 bf16 ulps there): catches a few rows gone wrong, which
# barely move a relative l2 error over millions of elements
MAX_ABS_TOL = 2.0 ** -5
# K3's f32 LSE against its plain version, absolute (measured 9.5e-7 on an
# H100): an LSE off by e scales every probability K4 rebuilds by exp(-e),
# so the relative limits above, at LSE values ~7, would pass a 10 % error
# in every gradient
LSE_ABS_TOL = 1e-4
# the int8 s2a's level-0 logits against the bf16 s2a's on one seeded canvas:
# measured 0.022 on an H100; the limit is about twice that, and a third of
# the 15 % loss rule the JAX package's own test holds int8 weights to
INT8_LOGITS_REL_L2_TOL = 0.05
# a decode against another decode of the same codes: bf16 through 17 conv
# stages rounded at other points
DECODE_REL_L2_TOL = 0.05
# one s2a micro-batch (B8 x 768, bf16 autocast) through K3+K4 against the
# same step through the plain attention: the flattened trainable gradient's
# relative l2 (measured 0.0039 on an H100; dk scaled by sqrt(D) in K4 gives
# 0.25) and the loss's relative difference (measured 2.3e-6)
TRAIN_GRAD_REL_L2_TOL = 0.02
TRAIN_LOSS_REL_TOL = 1e-3
# the s2a training recipe (configs/injection_conformer/train_config.yaml)
# cut to 6 steps with a 2-step warmup, on 48 seeded items of 800-1000 frames
TRAIN_STEPS = 6
TRAIN_ITEMS = 48
# the t2s recipe (configs/text_to_semantic_w_length/train_config.yaml) on
# more seeded items than length_bucketed's 2048-item pool, so its batches
# are length buckets
T2S_TRAIN_ITEMS = 2100
# gradient checkpointing: one s2a micro-batch with dropout under each
# policy against no remat; the recompute repeats the forward's arithmetic
# and dropout masks, so the gradients agree to the bit unless a policy or
# the dropout generator's restore is wrong
REMAT_DROPOUT = 0.1
REMAT_GRAD_REL_L2_TOL = 1e-3
# (f): timed runs per (variant, query tile) of the profiling script's sweep
ABLATION_RUNS = 10

KERNELS = {
    "resunit": dict(source="edm_tts_tpu_torch/csrc/resunit.cu",
                    replaces="edm_tts_tpu/ops/pallas_resunit.py:190"),
    "decoder_block": dict(source="edm_tts_tpu_torch/csrc/decoder_block.cu",
                          replaces="edm_tts_tpu/ops/pallas_decoder_block.py:287"),
    "attention": dict(source="edm_tts_tpu_torch/csrc/attention.cu",
                      replaces="edm_tts_tpu/ops/pallas_attention.py:83"),
    "attention_bwd": dict(source="edm_tts_tpu_torch/csrc/attention_bwd.cu",
                          replaces="edm_tts_tpu/ops/pallas_attention.py:234"),
    "int8_dense": dict(source="edm_tts_tpu_torch/csrc/qdense.cu",
                       replaces="edm_tts_tpu/ops/qdense.py:102"),
    "attn_variants": dict(source="edm_tts_tpu_torch/csrc/attn_variants.cu",
                          replaces="scripts/profile_attn_variants.py:55"),
}
# K3 with its LSE and K4: the s2a training micro-batch, a masked ragged batch
# and the masked t2s canvas (label: B, T, H, D, key lengths or None)
ATTENTION_TRAIN_CASES = (
    ("s2a train B8 T768 H16 D64", (8, 768, 16, 64, None)),
    ("ragged B4 T701 H8 D24 mask", (4, 701, 8, 24, (701, 650, 512, 97))),
    ("t2s canvas B4 T1382 H8 D24 mask", (4, 1382, 8, 24, (1382, 1210, 905, 488))),
)
# --source-faults: faults planted in copies of K3's, K4's and K6's CUDA
# sources, each of which the --attention-kernels cases must reject. name: (source in
# edm_tts_tpu_torch/csrc, [(text, replacement), ...]); every occurrence is
# replaced
SOURCE_FAULTS = {
    "delta dropped": ("attention_bwd.cu", [
        ("(dpt[n][e] - del)", "(dpt[n][e])"),
        ("(dp[n][e] - dl[e >> 1])", "(dp[n][e])")]),
    "dk without the scale": ("attention_bwd.cu", [
        ("dpt[n][e] = p * (dpt[n][e] - del) * scd;", "dpt[n][e] = p * (dpt[n][e] - del);")]),
    "mask ignored in the backward": ("attention_bwd.cu", [
        ("scan_key_tiles<kBwdWarps>(mask,", "scan_key_tiles<kBwdWarps>(nullptr,")]),
    "last query tile skipped": ("attention_bwd.cu", [
        ("const int nqt = (Tq + kTileRows - 1) / kTileRows;",
         "const int nqt = (Tq - 1) / kTileRows;")]),
    "LSE without log(l)": ("attention.cu", [("(m[r] + log2f(l[r])) * kLn2", "m[r] * kLn2")]),
    # the pipeline: a TMA coordinate one tile off (K in K3, V in K4's dq kernel)
    "K3's K tile copied one tile off": ("attention.cu", [
        ("&kmap, bar, 0, h, live[i] * kTileRows, b);",
         "&kmap, bar, 0, h, (live[i] + 1) * kTileRows, b);")]),
    "K4's dq V tile copied one tile off": ("attention_bwd.cu", [
        ("&vmap, bar, 0, h, live[i] * kTileRows, b);",
         "&vmap, bar, 0, h, (live[i] + 1) * kTileRows, b);")]),
    "K6 online rescale dropped": ("attn_variants.cu", [
        ("const float alpha[2] = {ex2_f32(m[0] - mx[0]), ex2_f32(m[1] - mx[1])};",
         "const float alpha[2] = {1.0f, 1.0f};")]),
    "K6 noexp without m * colsum(V)": ("attn_variants.cu", [
        ("if (VARIANT == kNoExp) x -= num_shift[r] * vsum_s[d];", "")]),
}


class CheckFailed(SystemExit):
    """A result outside its limit: exit code 1 (3 under ``--attention-kernels``)."""


def fail(msg: str) -> None:
    raise CheckFailed(f"chip_smoke: FAIL: {msg}")


def rel_l2(torch, out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def kernel_phase(torch, ops, attention_train_only: bool = False) -> dict:
    """Each kernel against its plain version at the slices' shapes; with
    ``attention_train_only`` only K3 with its LSE, K4 and K6's ragged cases
    (what ``--source-faults`` needs).

    Alphas are drawn U(0.5, 2), biases N(0, 0.5) and the int8 weights'
    column magnitudes U(0.5, 2), so that every term of the arithmetic moves
    the output by more than the limit.
    """
    import torch.nn.functional as F

    from edm_tts_tpu_torch.ops.attn_variants import BLOCK_Q, VARIANTS, attn_variant_reference
    from edm_tts_tpu_torch.ops.decoder_block import phase_weights
    from edm_tts_tpu_torch.profile_attn_variants import SHAPE
    from edm_tts_tpu_torch.profile_attn_variants import work as variant_work
    from edm_tts_tpu_torch.utils.devtime import bound, median_ms

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def tile(b, h, t):  # K3's query rows per block at this launch
        return f"block_q {ops.attention.attention_query_tile(b, h, t, sms)}"

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def uniform(*shape, lo, hi):
        return lo + torch.rand(*shape, generator=gen, device=dev) * (hi - lo)

    def alpha(c):
        return uniform(c, lo=0.5, hi=2.0)

    def resunit_params(c):
        """(alpha1, w7, b7, alpha2, w1, b1) as K1 takes them."""
        b7 = (7 * c) ** -0.5
        return (alpha(c), uniform(7, c, c, lo=-b7, hi=b7).to(bf16), normal(c, scale=0.5),
                alpha(c), uniform(1, c, c, lo=-c ** -0.5, hi=c ** -0.5).to(bf16),
                normal(c, scale=0.5))

    def replaced(params, i, value):
        return tuple(value if j == i else p for j, p in enumerate(params))

    cases: dict[str, list] = {name: [] for name in KERNELS}

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def compare(name, label, kernel, plain, faults, work, library=None):
        """``work``: (operations, bytes) the function needs on these inputs;
        ``library``: (name, fn) of one PyTorch call computing it, or None,
        or (name, fn, fn_subtracted): the time of the first less the second.
        A function of several outputs (K3 with its LSE, K4) is held to the
        limits on each; a fault is rejected when any output leaves them."""
        out = as_tuple(kernel())
        torch.cuda.synchronize()
        ref = as_tuple(plain())
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            if o.shape != r.shape or not torch.isfinite(o).all():
                fail(f"{label}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite output")
        errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
        tols = [MAX_ABS_TOL * r.float().abs().max().item() for r in ref]
        err, max_abs_tol = max(errs), max(tols)
        rel = max(rel_l2(torch, o, r) for o, r in zip(out, ref))
        fault_rel = {f: max(rel_l2(torch, o, r) for o, r in zip(as_tuple(fn()), ref))
                     for f, fn in faults.items()}
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        library_ms = None
        if library is not None:
            library_ms = median_ms(library[1])
            if len(library) == 3:
                library_ms -= median_ms(library[2])
        bound_ms, bound_by = bound(*work)
        print(f"kernel {name} {label}: rel_l2 {rel:.6g} (tol {REL_L2_TOL:.6g}) max_abs_err "
              f"{err:.6g} (tol {max_abs_tol:.4g}) planted faults rel_l2 "
              f"{ {f: round(r, 5) for f, r in fault_rel.items()} } "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ({library[0]})'} "
              f"bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
        if not (rel <= REL_L2_TOL and all(e <= t for e, t in zip(errs, tols))):  # NaN fails too
            fail(f"{label}: rel l2 {rel} / max abs {err} above {REL_L2_TOL} / {max_abs_tol}")
        weak = [f for f, r in fault_rel.items() if not r > REL_L2_TOL]
        if weak:
            fail(f"{label}: the limit would let the planted faults {weak} pass")
        cases[name].append(dict(case=label, rel_l2=rel, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=library_ms,
                                library=None if library is None else library[0],
                                bound_ms=bound_ms, bound_by=bound_by,
                                planted_fault_rel_l2=fault_rel))

    # K3 with its LSE and K4 (attention_bwd, both of its kernels) at
    # ATTENTION_TRAIN_CASES. The library calls are SDPA with the same bool
    # mask on inputs that require grad: for K3 its forward (which keeps its
    # LSE for the backward), for K4 its backward (forward and backward timed
    # together, the forward subtracted). K4's plain version takes the plain
    # LSE, so an LSE error of K3 also shows in dq, dk and dv.
    for label, (b, t, h, d, lens) in ATTENTION_TRAIN_CASES:
        q, k, v, g = (normal(b, t, h, d).to(bf16) for _ in range(4))
        mask = None
        n_keys = [t] * b
        if lens is not None:
            mask = torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
            n_keys = list(lens)
        o, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
        lse_ref = ops.attention_lse_reference(q, k, mask=mask)
        torch.cuda.synchronize()
        last = (t - 1) // 64 * 64  # the first query row of the last tile
        g_cut = g.clone()
        g_cut[:, last:] = 0
        elems = b * t * h * d
        key_work = sum(n_keys) * t * h * d  # per (query, valid key, head, depth)

        def plain_lse(mask=mask):
            return ops.mha_reference(q, k, v, mask=mask), ops.attention_lse_reference(q, k, mask=mask)

        def cut_last_tile():
            ref_o, ref_lse = plain_lse()
            ref_o = ref_o.clone()
            ref_o[:, last:] = 0
            return ref_o, ref_lse

        faults = {"last query tile skipped": cut_last_tile}
        if mask is not None:
            faults["mask ignored"] = lambda: plain_lse(None)
        qt, kt, vt = (z.transpose(1, 2).contiguous().requires_grad_() for z in (q, k, v))
        gt = g.transpose(1, 2).contiguous()
        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def sdpa_fwd():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

        # SDPA on inputs that require grad keeps its LSE for the backward
        # one exponential per (query, valid key, head): K3's, and K4's to
        # rebuild p (once, as one kernel doing both of K4's parts would)
        exps = sum(n_keys) * t * h
        compare("attention", f"{label} with LSE, {tile(b, h, t)}",
                lambda: ops.flash_mha(q, k, v, mask=mask, return_lse=True), plain_lse, faults,
                (4 * key_work, 4 * elems * 2 + b * t + b * h * t * 4, exps),
                ("scaled_dot_product_attention, inputs requiring grad", sdpa_fwd))
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"kernel attention {label} with LSE: LSE max abs err {lse_err:.4g} "
              f"(tol {LSE_ABS_TOL})", flush=True)
        if not lse_err <= LSE_ABS_TOL:
            fail(f"{label}: K3's LSE is off by {lse_err}, above {LSE_ABS_TOL}")

        def bwd_plain(mask=mask, o=o, g=g):
            return ops.flash_mha_bwd_reference(q, k, v, mask, o, lse_ref, g)

        def dk_unscaled():
            dq, dk, dv = bwd_plain()
            return dq, dk * d ** 0.5, dv

        faults = {"delta dropped": lambda: bwd_plain(o=torch.zeros_like(o)),
                  "dk without the scale": dk_unscaled,
                  "last query tile skipped": lambda: bwd_plain(g=g_cut)}
        if mask is not None:
            faults["mask ignored"] = lambda: bwd_plain(mask=None)
        compare("attention_bwd", label,
                lambda: ops.flash_mha_bwd(q, k, v, mask, o, lse, g), bwd_plain, faults,
                (10 * key_work, 8 * elems * 2 + b * h * t * 4 + b * t, exps),
                ("scaled_dot_product_attention backward", sdpa_fwd_bwd, sdpa_fwd))
        if mask is not None:  # keys at padded positions get exactly zero dk and dv
            _, dk, dv = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
            if dk[~mask].any() or dv[~mask].any():
                fail(f"{label}: K4 wrote non-zero dk or dv at padded keys")
            print(f"kernel attention_bwd {label}: dk and dv exactly 0 at "
                  f"{int((~mask).sum())} padded keys", flush=True)
    # K6: each variant at each query tile, at the ablation's shape (B32
    # T1408 H16 D24; not under --attention-kernels) and at two ragged ones.
    # The library call is SDPA (the full softmax) on the (B, H, T, D) layout.
    k6_shapes = [(2, 701, 8, 24), (2, 701, 8, 64)]
    if not attention_train_only:
        k6_shapes.insert(0, SHAPE)
    for b, t, h, d in k6_shapes:
        q, k, v = (normal(b, t, h, d).to(bf16) for _ in range(3))
        last = (t - 1) // 64 * 64  # the first key of the last tile
        k_cut, v_cut = k[:, :last].contiguous(), v[:, :last].contiguous()
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))

        def noexp_without_max():
            s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * d ** -0.5
            o = torch.einsum("bhij,bjhd->bihd", s.to(bf16).float(), v.float())
            return (o / (s.sum(-1) + 1e6).transpose(1, 2)[..., None]).to(bf16)

        for variant in VARIANTS:
            faults = {"scale dropped": lambda: attn_variant_reference(
                          q * d ** 0.5, k, v, variant=variant),
                      "last key tile skipped": lambda: attn_variant_reference(
                          q, k_cut, v_cut, variant=variant)}
            if variant == "noexp":
                # the max left out of both terms (out of the denominator
                # alone it moves the output by ~0.5 %, under the limit)
                faults["row max left out"] = noexp_without_max
            for block_q in BLOCK_Q:
                compare("attn_variants", f"B{b} T{t} H{h} D{d} {variant} block_q {block_q}",
                        lambda: ops.attn_variant(q, k, v, variant=variant, block_q=block_q),
                        lambda: attn_variant_reference(q, k, v, variant=variant), faults,
                        variant_work(variant, b, t, h, d),
                        ("scaled_dot_product_attention",
                         lambda: F.scaled_dot_product_attention(qt, kt, vt)))
    if attention_train_only:
        return cases

    def resunit_work(b, t, c):
        return 2 * b * t * c * c * 8, 2 * 2 * b * t * c + 8 * c * c * 2 + 4 * c * 4

    # K1: decoder blocks 0 and 1 (C 768 at T 4000, C 384 at T 20002); on the
    # masked decode also the tail blocks' units (C 192 at T 80008, C 96 at
    # T 160016): a 500-frame canvas
    for t, c in ((4000, 768), (20002, 384), (80008, 192), (160016, 96)):
        x = normal(1, t, c).to(bf16)
        for d in (1, 3, 9):
            p = resunit_params(c)
            compare("resunit", f"T{t} C{c} dil{d}",
                    lambda: ops.fused_residual_unit(x, *p, d),
                    lambda: ops.resunit_reference(x, *p, dilation=d),
                    {"b1 dropped": lambda: ops.resunit_reference(
                        x, *replaced(p, 5, p[5] * 0), dilation=d),
                     "alpha1 = 1": lambda: ops.resunit_reference(
                        x, *replaced(p, 0, p[0] * 0 + 1), dilation=d)},
                    resunit_work(1, t, c))
    # K2: the s=4 and s=2 tail blocks
    for s, t, cin, cout in ((4, 20002, 384, 192), (2, 80008, 192, 96)):
        x = normal(1, t, cin).to(bf16)
        a0 = alpha(cin)
        bound_ = (2 * s * cout) ** -0.5
        w3 = phase_weights(uniform(2 * s, cin, cout, lo=-bound_, hi=bound_).to(bf16), s).contiguous()
        bias3 = normal(cout, scale=0.5).repeat(s)
        rus = [resunit_params(cout) for _ in range(3)]
        # the transposed conv takes 2 taps per output sample; the units' work
        # is 3 K1s at the output rate; x read once, the output written once
        tconv_flops = 2 * t * s * cin * cout * 2
        units_flops, _ = resunit_work(1, t * s, cout)
        weight_bytes = 2 * s * cin * cout * 2 + 3 * 8 * cout * cout * 2
        compare("decoder_block", f"s{s} T{t} C{cin}->{cout}",
                lambda: ops.fused_decoder_block(x, a0, w3, bias3, rus, s),
                lambda: ops.decoder_block_reference(x, a0, w3, bias3, rus, stride=s),
                {"bias dropped": lambda: ops.decoder_block_reference(
                    x, a0, w3, bias3 * 0, rus, stride=s),
                 "alpha0 = 1": lambda: ops.decoder_block_reference(
                    x, a0 * 0 + 1, w3, bias3, rus, stride=s)},
                (tconv_flops + 3 * units_flops, 2 * t * cin + 2 * t * s * cout + weight_bytes))
    # K3: t2s (masked canvas), the length predictor, s2a without and with a
    # key mask. The t2s and s2a masks also cover the first 70 keys, so every
    # row's first KV tile is fully masked. The library call is SDPA on the
    # (B, H, T, D) layout with the same boolean mask (layouts made untimed).
    for label, (t, h, d, lo, hi) in (("t2s T604 H8 D24 mask", (604, 8, 24, 70, 553)),
                                     ("length predictor T101 H8 D24 mask", (101, 8, 24, 0, 90)),
                                     ("s2a T650 H16 D64", (650, 16, 64, None, None)),
                                     ("s2a T650 H16 D64 mask", (650, 16, 64, 70, 599))):
        q, k, v = (normal(1, t, h, d).to(bf16) for _ in range(3))
        pos = torch.arange(t, device=dev)[None]
        mask = None if lo is None else (pos >= lo) & (pos < hi)
        valid = torch.ones_like(pos, dtype=torch.bool) if mask is None else mask
        faults = {}
        tail = valid & (pos < t // 64 * 64)  # the keys of the last, partial tile dropped
        if not torch.equal(tail, valid):
            faults["tail tile dropped"] = lambda: ops.mha_reference(q, k, v, mask=tail)
        if mask is not None:
            faults["mask ignored"] = lambda: ops.mha_reference(q, k, v)
        if d % 32:  # scaled by the depth the kernel pads D to, not by D
            faults["scaled by padded D"] = lambda: ops.mha_reference(
                q * (d / (-(-d // 32) * 32)) ** 0.5, k, v, mask=mask)
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        n_keys = int(valid.sum())
        compare("attention", f"{label}, {tile(1, h, t)}", lambda: ops.flash_mha(q, k, v, mask=mask),
                lambda: ops.mha_reference(q, k, v, mask=mask), faults,
                (4 * h * t * n_keys * d, 4 * t * h * d * 2 + t, h * t * n_keys),
                ("scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask)))
    # K5: every int8 linear of the served path. s2a at M = 150 + 512 (a
    # 500-frame request), t2s at M = 128 + 4 + 1250 (text bucket 128), the
    # length predictor at M = 1 + 128, and a batch of 4 s2a rows.
    int8_pack_mm = None
    k5_cases = [
        *(("s2a", 662, 1024, n) for n in (1024, 2048, 4096, 8192)),
        ("s2a", 662, 4096, 1024), ("s2a", 662, 2048, 1024),
        *(("t2s", 1382, 384, n) for n in (384, 1536, 1024)),
        ("t2s", 1382, 1536, 384), ("t2s", 1382, 768, 384), ("t2s", 1382, 192, 384),
        ("length predictor", 129, 384, 384), ("s2a batch 4", 4 * 662, 1024, 4096),
    ]
    for label, m, kdim, n in k5_cases:
        x = normal(m, kdim).to(bf16)
        q8, scale = ops.quantize_weight(normal(kdim, n) * uniform(n, lo=0.5, hi=2.0))
        tail_start = m // 64 * 64 if m % 64 else m - 64
        qt8, scale16 = q8.t().contiguous(), scale.to(bf16)
        if int8_pack_mm is None:  # a CUDA int8 weight-only product in this PyTorch?
            try:
                torch._weight_int8pack_mm(x, qt8, scale16)
                int8_pack_mm = True
            except (RuntimeError, NotImplementedError, AttributeError) as e:
                print(f"kernel int8_dense: torch._weight_int8pack_mm is not available on "
                      f"CUDA here ({type(e).__name__}); its library_ms is torch.matmul "
                      f"on the bf16-dequantized weight, the dequant untimed", flush=True)
                int8_pack_mm = False
        w_deq = (q8.float() * scale).to(bf16)
        if int8_pack_mm:
            library = ("_weight_int8pack_mm", lambda: torch._weight_int8pack_mm(x, qt8, scale16))
        else:
            library = ("matmul bf16-dequantized", lambda: torch.matmul(x, w_deq))

        def tail_zeroed():
            out = ops.int8_dense_reference(x, q8, scale)
            out[tail_start:] = 0
            return out

        compare("int8_dense", f"{label} M{m} K{kdim} N{n}",
                lambda: ops.int8_dense(x, q8, scale),
                lambda: ops.int8_dense_reference(x, q8, scale),
                {"scale ignored": lambda: (x.float() @ q8.float()).to(bf16),
                 "scale by row": lambda: ((x.float() @ q8.float())
                                          * scale[torch.arange(m, device=dev) % n][:, None]).to(bf16),
                 "last K step dropped": lambda: ops.int8_dense_reference(
                     x[:, :-32], q8[:-32], scale),
                 "tail M rows zeroed": tail_zeroed},
                (2 * m * kdim * n, 2 * m * kdim + kdim * n + 2 * m * n + 4 * n), library)
        # a second yardstick: the bf16 product on the dequantized weight
        cases["int8_dense"][-1]["matmul_bf16_ms"] = median_ms(lambda: torch.matmul(x, w_deq))
        print(f"kernel int8_dense {label} M{m} K{kdim} N{n}: bf16 matmul on the dequantized "
              f"weight ms {cases['int8_dense'][-1]['matmul_bf16_ms']:.4f}", flush=True)
    return cases


def decode_plain(torch, ops, codec, codes):
    """The codec decode of ``codes`` through the kernels' plain versions."""
    x = codec.quantizer.from_codes(codes).to(codec.dtype)
    stem, *blocks, snake, final = codec.decoder.model
    x = stem(x)
    for block in blocks:
        snake0, tconv, *units = block.block
        x = tconv(snake0(x))
        for u in units:
            x = ops.resunit_reference(x, *u.folded(), dilation=u.dilation)
    return torch.tanh(final(snake(x)))


def block_int8_sites(cfg) -> int:
    """How many of a Conformer block's nine linears pass the K5 shape gate."""
    from edm_tts_tpu_torch.ops import quantizable_shape

    d, inner, ff = cfg.dim, cfg.heads * cfg.dim_head, cfg.dim * cfg.ff_mult
    conv = cfg.dim * cfg.conv_expansion_factor
    shapes = [(d, ff), (ff, d), (d, inner), (d, 2 * inner), (inner, d), (d, 2 * conv),
              (conv, d), (d, ff), (ff, d)]
    return sum(quantizable_shape(k, n) for k, n in shapes)


def served_path(torch, t2s, s2a, dev, smi: str) -> dict:
    """(c): the int8 models behind TTSEngine -> DynamicBatcher -> TTSServer."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from scipy.io import wavfile

    from edm_tts_tpu_torch.kernels import launches, reset_launches
    from edm_tts_tpu_torch.ops import quantizable_shape
    from edm_tts_tpu_torch.profile_synthesis import (
        PRED_ITERS,
        PROMPT_FRAMES,
        SERVED_TEXTS,
        STEPS,
        served_engine,
    )
    from edm_tts_tpu_torch.serving import TTSServer
    from edm_tts_tpu_torch.serving.chunking import split_text

    t2s_cfg, s2a_cfg = t2s.cfg, s2a.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)

    # the bf16 s2a's level-0 logits on a 662-frame canvas, before the engine
    # quantizes the models in place
    tokens = torch.randint(0, s2a_cfg.num_semantic_tokens, (1, PROMPT_FRAMES + 512),
                           generator=gen, device=dev)
    canvas = s2a.embed_semantic(tokens) + s2a.mask_token
    logits_bf16 = s2a.forward_first_level(canvas)
    engine = served_engine(t2s, s2a, dev, SEED + 30)
    rel = rel_l2(torch, engine.s2a.forward_first_level(canvas), logits_bf16)
    print(f"served (c) int8 vs bf16 s2a level-0 logits on a {canvas.shape[1]}-frame canvas: "
          f"relative l2 {rel:.4g} (tol {INT8_LOGITS_REL_L2_TOL})", flush=True)
    if not rel <= INT8_LOGITS_REL_L2_TOL:
        fail(f"int8 s2a logits differ from the bf16 ones: relative l2 {rel}")
    engine.synthesize(["A warm-up request before the server starts."], "spk", gt_lengths=[100])

    def expected(has_gt: bool) -> dict:
        main, lp = t2s_cfg.main_encoder_config, t2s_cfg.length_predictor_config
        enc, h = s2a_cfg.encoder_config, t2s_cfg.hidden_size
        s2a_passes = (s2a_cfg.injection_layers[0] + 1) * STEPS + s2a_cfg.encoder_num_layers
        fine = quantizable_shape(s2a_cfg.hidden_size, s2a_cfg.hidden_size * (
            s2a_cfg.num_quantizers - len(s2a_cfg.injection_layers)))
        int8 = (PRED_ITERS * (main.depth * block_int8_sites(main)
                              + quantizable_shape(h, h)
                              + quantizable_shape(h, t2s_cfg.semantic_vocab_size))
                + (0 if has_gt else lp.depth * block_int8_sites(lp))
                + s2a_passes * block_int8_sites(enc) + fine)
        attention = (main.depth * PRED_ITERS + (0 if has_gt else lp.depth) + s2a_passes)
        return no_launches(resunit=3 * len(s2a_cfg.codec.decoder_rates), attention=attention,
                           int8_dense=int8)

    calls = []  # (rows, engine wall s, audio s) of each engine call the server makes
    synthesize = engine.synthesize

    def timed_synthesize(texts, speaker, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = synthesize(texts, speaker, **kw)
        torch.cuda.synchronize()
        calls.append((len(texts), time.perf_counter() - t0,
                      sum(len(w) for w in wavs) / engine.sample_rate))
        return wavs

    engine.synthesize = timed_synthesize
    server = TTSServer(engine, max_batch=16, max_wait_ms=1000.0).start()
    base = f"http://{server.host}:{server.port}"

    def post(body: dict):
        req = urllib.request.Request(f"{base}/synthesize", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, data = r.status, r.read()
        sr, pcm = wavfile.read(io.BytesIO(data))
        return status, sr, pcm, time.perf_counter() - t0

    def check_wav(label, status, sr, pcm, want_samples=None):
        hop = engine.hop_length
        rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))) if pcm.size else 0.0
        if status != 200 or sr != engine.sample_rate or pcm.dtype != np.int16:
            fail(f"{label}: HTTP {status}, {sr} Hz, {pcm.dtype}")
        if want_samples is not None and pcm.shape != (want_samples,):
            fail(f"{label}: {pcm.shape} samples, want ({want_samples},)")
        if want_samples is None and (pcm.size == 0 or pcm.size % hop):
            fail(f"{label}: {pcm.size} samples is not a whole number of {hop}-sample frames")
        if not rms > 0:
            fail(f"{label}: silent WAV")
        return rms

    texts = SERVED_TEXTS
    bodies = [{"text": t, "speaker": "spk", "seed": 7} for t in texts]
    bodies[3]["gt_length"] = 500
    counts = {}
    try:
        # four concurrent requests: the three without a length share one
        # engine call, the one with a length gets its own
        reset_launches()
        with ThreadPoolExecutor(4) as pool:
            results = list(pool.map(post, bodies))
        torch.cuda.synchronize()
        counts["concurrent"] = dict(launches)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=60).read())
        for i, (status, sr, pcm, lat) in enumerate(results):
            want = 500 * engine.hop_length if "gt_length" in bodies[i] else None
            rms = check_wav(f"request {i}", status, sr, pcm, want)
            print(f"served (c) request {i}: {len(texts[i].encode())} text bytes, "
                  f"{pcm.size / sr:.2f} s audio, rms {rms:.1f}, latency {lat:.4f} s "
                  f"(batch window 1.0 s)", flush=True)
        n_calls = stats["engine_calls"]
        if not stats["mean_batch"] > 1 or stats["failed"]:
            fail(f"the batcher did not coalesce the concurrent requests: {stats}")
        want = {k: expected(True)[k] + (n_calls - 1) * expected(False)[k] for k in KERNELS}
        print(f"served (c) concurrent: /stats {stats} launches {counts['concurrent']} "
              f"expected {want}", flush=True)
        if counts["concurrent"] != want:
            fail(f"served launches {counts['concurrent']} != expected {want}")
        for rows, wall, audio_s in calls:
            print(f"served (c) engine call: {rows} rows, wall {wall:.4f} s for {audio_s:.2f} s "
                  f"of audio: {wall / audio_s:.5f} s per audio s ({smi})", flush=True)

        # one long request of three chunks, through the same batcher
        long_text = (
            "The first chunk of this long request talks about the morning train, which "
            "was late again. The second chunk describes the crowded platform and the "
            "announcements that nobody could hear. The third and last chunk ends the "
            "story with a cup of coffee at the office, finally.")
        n_chunks = len(split_text(long_text, 120))
        reset_launches()
        calls_before = len(calls)
        status, sr, pcm, lat = post({"text": long_text, "speaker": "spk", "seed": 3,
                                     "long": True, "max_chunk_chars": 120})
        torch.cuda.synchronize()
        counts["long"] = dict(launches)
        rms = check_wav("long request", status, sr, pcm)
        n_long = len(calls) - calls_before
        want = {k: n_long * expected(False)[k] for k in KERNELS}
        print(f"served (c) long request: {n_chunks} chunks in {n_long} engine call(s), "
              f"{pcm.size / sr:.2f} s audio, rms {rms:.1f}, latency {lat:.4f} s, "
              f"launches {counts['long']} expected {want}", flush=True)
        if n_chunks != 3 or counts["long"] != want:
            fail(f"long request: {n_chunks} chunks, launches {counts['long']} != {want}")
    finally:
        server.shutdown()

    # the masked decode of a padded canvas against exact-size decodes
    codec = engine.s2a.acoustic_model
    codes = torch.randint(0, s2a_cfg.num_codevectors, (2, s2a_cfg.num_quantizers, 512),
                          generator=gen, device=dev)
    valid = torch.tensor([500, 333], device=dev)
    masked = codec.decode_from_codes(codes, valid)
    for i, v in enumerate(valid.tolist()):
        exact = codec.decode_from_codes(codes[i:i + 1, :, :v])
        n = v * engine.hop_length
        rel = rel_l2(torch, masked[i, :n], exact[0, :n])
        print(f"served (c) masked decode row {i} ({v} of 512 frames) vs exact-size decode: "
              f"relative l2 {rel:.4g} (tol {DECODE_REL_L2_TOL})", flush=True)
        if not rel <= DECODE_REL_L2_TOL:
            fail(f"masked decode row {i} differs from the exact-size decode: {rel}")
    return counts["concurrent"]


def write_s2a_shards(path: str) -> None:
    """TRAIN_ITEMS seeded items of 800-1000 frames, 12 x 1024 codes."""
    import numpy as np

    from edm_tts_tpu_torch.data.token_shards import TokenShardWriter

    rng = np.random.default_rng(SEED)
    writer = TokenShardWriter(path, items_per_shard=16)
    for i in range(TRAIN_ITEMS):
        t = int(rng.integers(800, 1001))
        writer.add(f"utt{i}", rng.integers(0, 1024, (12, t)), rng.integers(0, 1024, t))
    writer.close()


def attention_gradient_check(torch, ops, model, loss, label: str) -> dict:
    """``loss(model)``'s loss and flattened trainable gradient through K3+K4
    against the same with the Conformer's attention replaced by the plain
    version for one call (and with a planted K4 fault: dk scaled by
    sqrt(D)); returns the launches of the kernel run."""
    import edm_tts_tpu_torch.models.conformer.conformer as conformer_mod
    import edm_tts_tpu_torch.ops.attention as attention_mod
    from edm_tts_tpu_torch.kernels import launches, reset_launches

    def loss_and_grad():
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            value = loss(model)
            value.backward()
        grad = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
        model.zero_grad(set_to_none=True)
        return value.item(), grad

    reset_launches()
    loss_k, grad_k = loss_and_grad()
    torch.cuda.synchronize()
    counts = dict(launches)
    true_mha = conformer_mod.mha

    def plain_mha(q, k, v, *, mask=None, implementation="auto"):
        return ops.mha_reference(q, k, v, mask=mask)

    conformer_mod.mha = plain_mha
    reset_launches()
    try:
        loss_p, grad_p = loss_and_grad()
    finally:
        conformer_mod.mha = true_mha
    if launches["attention"] or launches["attention_bwd"]:
        fail(f"{label}: the plain-attention step launched kernels: {dict(launches)}")
    true_bwd = attention_mod.flash_mha_bwd

    def dk_scaled_wrong(q, k, v, mask, o, lse, g):
        dq, dk, dv = true_bwd(q, k, v, mask, o, lse, g)
        return dq, dk * q.shape[-1] ** 0.5, dv

    attention_mod.flash_mha_bwd = dk_scaled_wrong
    try:
        _, grad_fault = loss_and_grad()
    finally:
        attention_mod.flash_mha_bwd = true_bwd
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = rel_l2(torch, grad_k, grad_p)
    fault_rel = rel_l2(torch, grad_fault, grad_p)
    del grad_k, grad_p, grad_fault
    print(f"{label}, K3+K4 vs plain attention: loss {loss_k:.6f} vs {loss_p:.6f} (relative "
          f"{loss_rel:.3g}, tol {TRAIN_LOSS_REL_TOL}), gradient relative l2 {grad_rel:.4g} (tol "
          f"{TRAIN_GRAD_REL_L2_TOL}); planted K4 fault (dk scaled by sqrt(D)) {fault_rel:.4g}; "
          f"launches {counts}", flush=True)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= TRAIN_GRAD_REL_L2_TOL):
        fail(f"{label}: the gradient through the kernels differs from the plain attention: "
             f"loss {loss_rel}, gradient {grad_rel}")
    if not fault_rel > TRAIN_GRAD_REL_L2_TOL:
        fail(f"{label}: the gradient limit would let a wrong dk pass ({fault_rel})")
    return counts


def no_launches(**counts) -> dict:
    """A launch-count dict of every kernel: 0 unless given."""
    return {name: counts.get(name, 0) for name in KERNELS}


def training_path(torch, ops, dev, smi: str) -> dict:
    """(d): the s2a recipe at full width through ``run_s2a.main_from_dict``."""
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.kernels import launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe
    from edm_tts_tpu_torch.train import run_s2a

    tmp = tempfile.mkdtemp(prefix="chip_smoke_s2a_")
    try:
        shards = os.path.join(tmp, "shards")
        write_s2a_shards(shards)
        raw = s2a_train_recipe(os.path.join(tmp, "out"), shards, SEED, TRAIN_STEPS)
        micro = raw["per_device_train_batch_size"] // raw["micro_batches"]

        # one micro-batch's loss and gradient: K3 + K4 against the plain
        # attention, on the seeded init main_from_dict starts from
        model = run_s2a.build_model(raw, dev)
        cfg = model.cfg
        frames = int(raw["training_segment_length"] * cfg.codec.sample_rate / cfg.codec.hop_length)
        before = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        batch = next(run_s2a.code_batch_iterator(shards, frames, micro, SEED))
        ac, sem = (torch.as_tensor(batch[k], device=dev)
                   for k in ("acoustic_tokens", "semantic_tokens"))
        mask = ops.cosine_schedule_mask(torch.Generator(device=dev).manual_seed(SEED),
                                        micro, frames, device=dev)

        def loss(m):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return m.forward_train(ac, sem, mask_override=mask, train=False)["loss"]

        check_counts = attention_gradient_check(
            torch, ops, model, loss, f"train (d) one micro-batch B{micro} x {frames}")
        del model
        depth = cfg.encoder_num_layers
        if check_counts["attention"] != depth or check_counts["attention_bwd"] != depth:
            fail(f"one micro-batch launched {check_counts}, want {depth} of K3 and of K4")

        # the main path: 6 optimizer steps of B32 x 768 in 4 micro-batches
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        free = shutil.disk_usage(tmp).free
        reset_launches()
        t0 = time.perf_counter()
        trainer = run_s2a.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        losses = [r["train/loss"] for r in steps]
        norms = [r["train/grad_norm"] for r in steps]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        med = statistics.median(step_s[1:])  # the first step warms up
        n_micro = raw["micro_batches"]
        want = no_launches(attention=depth * n_micro * TRAIN_STEPS,
                           attention_bwd=depth * n_micro * TRAIN_STEPS)
        save = trainer.last_save
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(save["path"]) for f in fs)
        after = trainer.model.state_dict()
        codec_same = all(torch.equal(before[k], after[k].cpu())
                         for k in before if k.startswith("acoustic_model."))
        trainable = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
        still = [n for n in trainable if torch.equal(before[n], after[n].cpu())]
        print(f"train (d) {len(steps)} steps of B{raw['per_device_train_batch_size']} x "
              f"{frames} frames ({n_micro} micro-batches), {len(trainable)} trainable tensors "
              f"({sum(p.numel() for p in trainer.optimizer.params) / 1e6:.1f}M): losses "
              f"{[round(x, 4) for x in losses]} grad norms {[round(x, 4) for x in norms]} "
              f"lr {[r['train/lr'] for r in steps]}", flush=True)
        print(f"train (d) step seconds {[round(x, 4) for x in step_s]}: median {med:.4f} s "
              f"after the first, {raw['per_device_train_batch_size'] * frames / med:.1f} frames "
              f"per s; wall {wall:.2f} s with set-up, checkpoint and export; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); final checkpoint "
              f"{ckpt_bytes / 2 ** 30:.2f} GiB saved in {save['seconds']:.2f} s (disk free "
              f"before {free / 2 ** 30:.1f} GiB); launches {counts} expected {want} ({smi})",
              flush=True)
        if not all(np.isfinite(losses + norms)) or len(steps) != TRAIN_STEPS:
            fail(f"training: {len(steps)} steps, losses {losses}, grad norms {norms}")
        if not codec_same:
            fail("training changed the frozen codec's weights")
        if still:
            fail(f"training left trainable tensors unchanged: {still[:5]}")
        if counts != want:
            fail(f"training launches {counts} != expected {want}")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def t2s_training_path(torch, ops, dev, smi: str) -> dict:
    """(e): the t2s recipe at full width through ``run_t2s.main_from_dict``."""
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.data.token_shards import TokenShardWriter
    from edm_tts_tpu_torch.kernels import launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import t2s_train_recipe
    from edm_tts_tpu_torch.train import run_t2s

    tmp = tempfile.mkdtemp(prefix="chip_smoke_t2s_")
    try:
        # T2S_TRAIN_ITEMS items, more than length_bucketed's 2048-item pool:
        # semantic lengths U[21, 1249], text bytes 20-40 % of them
        rng = np.random.default_rng(SEED)
        shards = os.path.join(tmp, "shards")
        writer = TokenShardWriter(shards, items_per_shard=512)
        for i in range(T2S_TRAIN_ITEMS):
            t = int(rng.integers(21, 1250))
            n_text = max(1, int(t * rng.uniform(0.2, 0.4)))
            writer.add(f"utt{i}", np.zeros((1, t), np.int16), rng.integers(0, 1024, t),
                       text_bytes=rng.integers(0, 256, n_text).tolist())
        writer.close()
        raw = t2s_train_recipe(os.path.join(tmp, "out"), shards, SEED, TRAIN_STEPS)
        model = run_t2s.build_model(raw, dev)
        cfg = model.cfg
        depth = cfg.main_encoder_num_layers + cfg.length_predictor_num_layers
        before = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}

        # one batch of 8 (the plain attention keeps B x H x T x T scores),
        # the longest canvas of the iterator's first 8: K3 + K4 against the
        # plain attention
        batch = max(itertools.islice(run_t2s.t2s_batch_iterator(shards, 8, SEED), 8),
                    key=lambda b: b["input_ids"].shape[1])
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        mask = ops.cosine_schedule_mask(torch.Generator(device=dev).manual_seed(SEED),
                                        *batch["input_ids"].shape, device=dev)

        def loss(m):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return m.forward_train(*(batch[k] for k in run_t2s.BATCH_KEYS),
                                       mask_override=mask, train=False)["loss"]

        check_counts = attention_gradient_check(
            torch, ops, model, loss, f"train (e) one batch B8 x {batch['input_ids'].shape[1]}")
        del model
        if check_counts["attention"] != depth or check_counts["attention_bwd"] != depth:
            fail(f"one t2s batch launched {check_counts}, want {depth} of K3 and of K4")

        # the main path: 6 optimizer steps of B32; the iterator is seeded, so
        # the same iterator gives the canvases the trainer takes
        shapes = [(b["input_ids"].shape, b["text_ids"].shape[1] + 1) for b in itertools.islice(
            run_t2s.t2s_batch_iterator(shards, raw["per_device_train_batch_size"], SEED),
            TRAIN_STEPS)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        trainer = run_t2s.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        losses = [r["train/loss"] for r in steps]
        norms = [r["train/grad_norm"] for r in steps]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        tokens = [shape[0] * shape[1] for shape, _ in shapes]
        med = statistics.median(step_s[1:])  # the first step warms up
        rate = sum(tokens[1:]) / sum(step_s[1:])
        want = no_launches(attention=depth * TRAIN_STEPS, attention_bwd=depth * TRAIN_STEPS)
        after = trainer.model.state_dict()
        trainable = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
        still = [n for n in trainable if torch.equal(before[n], after[n].cpu())]
        canvases = sorted({shape[1] for shape, _ in shapes})
        print(f"train (e) {len(steps)} steps of B{raw['per_device_train_batch_size']}, canvases "
              f"(main x length predictor) {[(s[1], lp) for s, lp in shapes]}, "
              f"{len(trainable)} trainable tensors "
              f"({sum(p.numel() for p in trainer.optimizer.params) / 1e6:.1f}M): losses "
              f"{[round(x, 4) for x in losses]} (CE {[round(r['train/ce_loss'], 4) for r in steps]},"
              f" length {[round(r['train/length_loss'], 4) for r in steps]}) grad norms "
              f"{[round(x, 4) for x in norms]} lr {[r['train/lr'] for r in steps]}", flush=True)
        print(f"train (e) step seconds {[round(x, 4) for x in step_s]}: median {med:.4f} s "
              f"after the first, {rate:.1f} canvas tokens per s (steps 2-{TRAIN_STEPS}); wall "
              f"{wall:.2f} s with set-up, checkpoint and export; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches {counts} expected "
              f"{want} ({smi})", flush=True)
        if not all(np.isfinite(losses + norms)) or len(steps) != TRAIN_STEPS:
            fail(f"t2s training: {len(steps)} steps, losses {losses}, grad norms {norms}")
        if still:
            fail(f"t2s training left trainable tensors unchanged: {still[:5]}")
        if counts != want:
            fail(f"t2s training launches {counts} != expected {want}")
        if len(canvases) < 2 or any(s[1] % 64 or (lp - 1) % 64 for s, lp in shapes):
            fail(f"t2s canvases {shapes}: want at least two lengths, multiples of 64 (+1)")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def remat_path(torch, dev, smi: str) -> dict:
    """Gradient checkpointing on the full-width s2a: one B8 x 768 micro-batch
    with dropout 0.1 under each policy against no remat, then 2 steps of
    the recipe as B32 in one micro-batch under "mha"."""
    import dataclasses
    import tempfile

    from edm_tts_tpu_torch.kernels import launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe
    from edm_tts_tpu_torch.train import run_s2a

    tmp = tempfile.mkdtemp(prefix="chip_smoke_remat_")
    try:
        shards = os.path.join(tmp, "shards")
        write_s2a_shards(shards)
        raw = s2a_train_recipe(os.path.join(tmp, "out"), shards, SEED, 2)
        raw["extra_model_params"]["encoder_config"].update(
            ff_dropout=REMAT_DROPOUT, conv_dropout=REMAT_DROPOUT)
        model = run_s2a.build_model(raw, dev)
        cfg = model.cfg
        frames = int(raw["training_segment_length"] * cfg.codec.sample_rate / cfg.codec.hop_length)
        micro = raw["per_device_train_batch_size"] // raw["micro_batches"]
        batch = next(run_s2a.code_batch_iterator(shards, frames, micro, SEED))
        ac, sem = (torch.as_tensor(batch[k], device=dev)
                   for k in ("acoustic_tokens", "semantic_tokens"))
        depth = cfg.encoder_num_layers
        ref = None
        for policy in (None, "full", "mha", "dots"):
            model.cfg = dataclasses.replace(cfg, gradient_checkpointing=policy is not None,
                                            remat_policy=policy or cfg.remat_policy)
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            static = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            gen = torch.Generator(device=dev).manual_seed(SEED + 40)
            with torch.enable_grad():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    loss = model.forward_train(ac, sem, generator=gen)["loss"]
                loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            counts = dict(launches)
            grad = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
            model.zero_grad(set_to_none=True)
            rel = 0.0 if ref is None else rel_l2(torch, grad, ref)
            if ref is None:
                ref = grad
            want = no_launches(attention=depth * (2 if policy == "full" else 1),
                               attention_bwd=depth)
            print(f"remat {policy or 'none'}: one micro-batch B{micro} x {frames}, dropout "
                  f"{REMAT_DROPOUT}: loss {loss.item():.6f}, gradient relative l2 to no remat "
                  f"{rel:.3g} (tol {REMAT_GRAD_REL_L2_TOL}); peak device memory "
                  f"{peak / 2 ** 30:.2f} GiB, {(peak - static) / 2 ** 30:.2f} GiB above the "
                  f"weights (max_memory_allocated); launches {counts} expected {want}", flush=True)
            if not rel <= REMAT_GRAD_REL_L2_TOL:
                fail(f"remat {policy}: gradient differs from no remat by {rel}")
            if counts != want:
                fail(f"remat {policy}: launches {counts} != expected {want}")
        del model, ref, grad
        torch.cuda.empty_cache()

        # the recipe's B32 in one micro-batch under "mha"
        raw = s2a_train_recipe(os.path.join(tmp, "out_b32"), shards, SEED, 2)
        raw.update(micro_batches=1)
        raw["extra_model_params"].update(gradient_checkpointing=True, remat_policy="mha")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer = run_s2a.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        want = no_launches(attention=2 * depth, attention_bwd=2 * depth)
        print(f"remat mha: 2 steps of B32 x {frames} in one micro-batch: losses "
              f"{[round(r['train/loss'], 4) for r in steps]}, step seconds "
              f"{[round(x, 4) for x in step_s]} ({32 * frames / step_s[-1]:.1f} frames per s "
              f"at the second), peak device memory {peak / 2 ** 30:.2f} GiB "
              f"(max_memory_allocated); launches {counts} expected {want} ({smi})", flush=True)
        if len(steps) != 2 or not all(math.isfinite(r["train/loss"]) for r in steps):
            fail(f"remat mha B32: {steps}")
        if counts != want:
            fail(f"remat mha B32: launches {counts} != expected {want}")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ablation_path(torch, smi: str) -> tuple[dict, list]:
    """(f): K6 through the profiling script's sweep at its shape."""
    from edm_tts_tpu_torch.kernels import launches, reset_launches
    from edm_tts_tpu_torch.profile_attn_variants import inputs, sweep

    q, k, v = inputs(seed=SEED)
    reset_launches()
    rows = sweep(q, k, v, n=ABLATION_RUNS)
    torch.cuda.synchronize()
    counts = dict(launches)
    want = no_launches(attn_variants=len(rows) * (ABLATION_RUNS + 1))
    for row in rows:
        print(f"ablation (f) B{q.shape[0]} T{q.shape[1]} H{q.shape[2]} D{q.shape[3]} "
              f"{row['variant']} block_q {row['block_q']}: {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) ({smi})", flush=True)
    print(f"ablation (f): launches {counts} expected {want}", flush=True)
    if counts != want:
        fail(f"ablation launches {counts} != expected {want}")
    return counts, rows


def source_faults() -> int:
    """``--source-faults``: the ``--attention-kernels`` cases of the kernel phase on
    the sources as they are (which must pass), then once for each of
    SOURCE_FAULTS on a copy of the package and of this script in a temporary
    directory with that one edit, built there; each must be rejected."""
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    pkg = root / "edm_tts_tpu_torch"
    child = [sys.executable, "chip_smoke.py", "--attention-kernels"]
    print("source faults: the sources as they are (must pass)", flush=True)
    if subprocess.run(child, cwd=root, timeout=600).returncode != 0:
        fail("the --attention-kernels cases reject the sources as they are")
    passed = []
    for name, (source, edits) in SOURCE_FAULTS.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fault_") as tmp:
            shutil.copytree(pkg, Path(tmp) / pkg.name,
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy2(root / "chip_smoke.py", tmp)
            path = Path(tmp) / pkg.name / "csrc" / source
            text = path.read_text()
            for old, new in edits:
                if old not in text:
                    fail(f"source fault {name!r}: {old!r} is not in {source}")
                text = text.replace(old, new)
            path.write_text(text)
            print(f"source fault {name!r} planted in {source}:", flush=True)
            rc = subprocess.run(child, cwd=tmp, timeout=600).returncode
        if rc not in (0, 3):
            fail(f"the check of source fault {name!r} did not run to its end (exit {rc})")
        print(f"source fault {name!r}: {'passed' if rc == 0 else 'rejected'}", flush=True)
        if rc == 0:
            passed.append(name)
    print(f"source faults rejected: {len(SOURCE_FAULTS) - len(passed)} of {len(SOURCE_FAULTS)}",
          flush=True)
    if passed:
        fail(f"source faults passed the --attention-kernels cases: {passed}")
    return 0


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--source-faults", action="store_true",
                      help="plant SOURCE_FAULTS in copies of K3's, K4's and K6's "
                           "sources; each must be rejected")
    mode.add_argument("--attention-kernels", action="store_true",
                      help="only the K3-with-LSE/K4 and ragged K6 cases of the kernel "
                           "phase; exit 3 when one is outside its limits")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU")
    if args.source_faults:
        return source_faults()
    from edm_tts_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    if args.attention_kernels:
        try:
            kernel_phase(torch, ops, attention_train_only=True)
        except CheckFailed as e:
            print(e.code, file=sys.stderr, flush=True)
            return 3
        return 0
    from edm_tts_tpu_torch.kernels import build, launches, reset_launches
    from edm_tts_tpu_torch.models.s2a import s2a_sample
    from edm_tts_tpu_torch.models.t2s import t2s_sample
    from edm_tts_tpu_torch.pipeline import e2e_synthesize
    from edm_tts_tpu_torch.profile_synthesis import (
        GEN_FRAMES,
        PRED_ITERS,
        STEPS,
        bench_inputs,
        full_width_models,
    )

    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernels against their plain versions
    cases = kernel_phase(torch, ops)

    # 4. end to end at full width
    t0 = time.perf_counter()
    t2s, s2a = full_width_models(dev, SEED)
    t2s_cfg, s2a_cfg = t2s.cfg, s2a.cfg
    n_params = sum(p.numel() for m in (s2a, t2s) for p in m.parameters())
    print(f"models: {n_params / 1e6:.1f}M parameters in {time.perf_counter() - t0:.2f} s", flush=True)
    inp = bench_inputs(s2a_cfg, dev, SEED)
    text, text_len, gt_length = inp["text"], inp["text_len"], inp["gt_length"]
    prompt_ac, prompt_sem = inp["prompt_ac"], inp["prompt_sem"]
    hop = s2a_cfg.codec.hop_length
    n_samples = s2a.acoustic_model.decoded_length(GEN_FRAMES)

    def request(full_canvas: bool, seed: int):
        return e2e_synthesize(
            t2s, s2a, text, text_len, prompt_ac, prompt_sem,
            torch.Generator().manual_seed(seed), pred_iters=PRED_ITERS, steps=STEPS,
            max_speech_len=GEN_FRAMES, gt_length=gt_length if full_canvas else None,
            assume_full_canvas=full_canvas,
        )

    def expected_launches(full_canvas: bool) -> dict:
        attention = (t2s_cfg.main_encoder_num_layers * PRED_ITERS
                     + (0 if full_canvas else t2s_cfg.length_predictor_num_layers)
                     + (s2a_cfg.injection_layers[0] + 1) * STEPS + s2a_cfg.encoder_num_layers)
        # K2 takes the blocks the JAX package fuses: even stride dividing 40,
        # C_out <= 192 (decoder.py); K1 every residual unit of the decoder
        codec = s2a_cfg.codec
        fused = sum(1 for i, s in enumerate(codec.decoder_rates)
                    if s % 2 == 0 and 40 % s == 0 and codec.decoder_dim // 2 ** (i + 1) <= 192)
        return no_launches(resunit=3 * len(codec.decoder_rates), decoder_block=fused,
                           attention=attention)

    def check(label: str, out, full_canvas: bool, counts: dict):
        audio = out["audio"]
        if tuple(audio.shape) != (1, n_samples, 1):
            fail(f"{label}: audio shape {tuple(audio.shape)} != (1, {n_samples}, 1)")
        length = int(out["lengths"][0])
        valid = audio[:, : length * hop].float()
        rms = valid.square().mean().sqrt().item()
        if not torch.isfinite(audio).all() or not rms > 0:
            fail(f"{label}: audio not finite or silent (rms {rms})")
        codes, sem = out["acoustic_codes"], out["semantic_tokens"]
        if tuple(codes.shape) != (1, s2a_cfg.num_quantizers, GEN_FRAMES):
            fail(f"{label}: codes shape {tuple(codes.shape)}")
        if codes.min() < 0 or codes.max() >= s2a_cfg.num_codevectors:
            fail(f"{label}: codes out of range")
        if sem.min() < 0 or sem.max() >= t2s_cfg.semantic_vocab_size:
            fail(f"{label}: semantic tokens out of range")
        want = expected_launches(full_canvas)
        print(f"e2e {label}: audio {tuple(audio.shape)} length {length} frames "
              f"rms {rms:.4f} launches {counts} expected {want}", flush=True)
        if counts != want:
            fail(f"{label}: kernel launches {counts} != expected {want}")

    # (a) bench.py's request: gt_length 500 on the full canvas
    reset_launches()
    out_a = request(True, SEED)
    torch.cuda.synchronize()
    counts_a = dict(launches)
    check("(a) full canvas", out_a, True, counts_a)

    # the same codes decoded through the plain versions agree with the kernels
    plain_audio = decode_plain(torch, ops, s2a.acoustic_model, out_a["acoustic_codes"])
    rel = rel_l2(torch, out_a["audio"], plain_audio)
    print(f"e2e (a) decode vs plain versions: relative l2 error {rel:.4g} "
          f"(tol {DECODE_REL_L2_TOL})", flush=True)
    if not rel <= DECODE_REL_L2_TOL:
        fail(f"decode differs from the plain versions: relative error {rel}")

    # (b) the length predictor and the masked canvas
    reset_launches()
    out_b = request(False, SEED + 1)
    torch.cuda.synchronize()
    counts_b = dict(launches)
    check("(b) predicted length", out_b, False, counts_b)

    # wall seconds per second of audio of (a), after the warm-up above
    audio_s = GEN_FRAMES * hop / s2a_cfg.codec.sample_rate
    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request(True, SEED + 10 + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"e2e (a) rtf: {wall / audio_s:.5f} s per audio s (median wall {wall:.4f} s of "
          f"{[round(w, 4) for w in walls]}, {audio_s:.1f} s audio, {smi})", flush=True)

    # where the wall time of (a) goes, stage by stage
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    gen = torch.Generator().manual_seed(SEED + 20)
    t2s_out, t_t2s = timed(lambda: t2s_sample(
        t2s, text, text_len, gen, pred_iters=PRED_ITERS, max_speech_len=GEN_FRAMES,
        gt_length=gt_length))
    codes, t_s2a = timed(lambda: s2a_sample(
        s2a, t2s_out["semantic_tokens"], prompt_ac, prompt_sem, gen, steps=STEPS))
    _, t_dec = timed(lambda: s2a.decode_audio(codes))
    print(f"e2e (a) stages: t2s {t_t2s:.4f} s, s2a {t_s2a:.4f} s, decode {t_dec:.4f} s", flush=True)

    # 5. (c) the served path with int8 weights (quantizes the models in place)
    counts_c = served_path(torch, t2s, s2a, dev, smi)
    del t2s, s2a
    torch.cuda.empty_cache()

    # 6. (d) s2a training at full width
    counts_d = training_path(torch, ops, dev, smi)

    # 7. (e) t2s training at full width
    counts_e = t2s_training_path(torch, ops, dev, smi)

    # 8. gradient checkpointing on the full-width s2a
    remat_path(torch, dev, smi)

    # 9. (f) the attention-variant ablation through the profiling script
    counts_f, _ = ablation_path(torch, smi)

    by_path = {"a": counts_a, "b": counts_b, "c": counts_c, "d": counts_d, "e": counts_e,
               "f": counts_f}
    record = {"kernels": []}
    for name in KERNELS:
        cs = cases[name]
        lib = [c["library_ms"] for c in cs]
        ops_share = sum(c["bound_ms"] for c in cs if c["bound_by"] == "operations")
        record["kernels"].append(dict(
            name=name, route="cuda", **KERNELS[name],
            # the path the kernel runs on: K2 is off on the served masked
            # decode, K4 runs on the training paths only, K6 on the ablation
            launches=next((c[name] for c in (counts_c, counts_a, counts_d, counts_f)
                           if c[name]), 0),
            launches_by_path={p: c[name] for p, c in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in cs),
            rel_l2=max(c["rel_l2"] for c in cs),
            ms=sum(c["ms"] for c in cs),
            plain_ms=sum(c["plain_ms"] for c in cs),
            bound_ms=sum(c["bound_ms"] for c in cs),
            bound_by="operations" if ops_share * 2 >= sum(c["bound_ms"] for c in cs) else "bytes",
            library_ms=None if None in lib else sum(lib),
            cases=cs))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
