"""The numerical premise of the f32 kernels K4-f32 and K5-f32, on the CPU.

Both run their f32 products on the card's TF32 tensor cores with split
operands: x = hi + lo, hi = tf32(x) and lo = tf32(x - hi), each rounded to
nearest with ties away from zero (``cvt.rna.tf32.f32``'s rounding, which the
kernels do with the same two integer operations as ``tf32_rna`` here). K4-f32
(csrc/attention_bwd_f32.cu) takes each product as lo*hi + hi*lo + hi*hi
("3xTF32"); K5-f32 (csrc/qdense_f32.cu) splits only x, since an int8 weight
is exact in TF32, and takes x_hi W + x_lo W ("2xTF32"). The kernels run only
on the card (tests/test_torch_kernels_f32_gpu.py); here the same arithmetic
is emulated with torch bit operations (each TF32 product exact in f32, as in
the tensor cores) and held against the plain versions and the JAX package's
Pallas kernels (interpret mode, as the JAX package's own tests run them) at
the limits chip_smoke.py holds the kernels to: 2^-16 relative l2. One TF32
product alone must land outside that limit, or the limit could not tell
the split from plain TF32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.ops.pallas_attention import flash_mha as j_flash_mha
from edm_tts_tpu.ops.pallas_attention import flash_mha_bwd as j_flash_mha_bwd
from edm_tts_tpu.ops.qdense import int8_dense as j_int8_dense
from edm_tts_tpu_torch import ops

REL_L2_TOL = 2.0 ** -16  # chip_smoke.py's F32_REL_L2_TOL
BLOCK = 16  # the Pallas kernels' tiles in interpret mode


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: a half unit of the 13 dropped bits added to the magnitude's
    bits, then those bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ah, al), (bh, bl) = split(a), split(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def mm_tf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, tf32_rna(a), tf32_rna(b))


def rel_l2(out, ref) -> float:
    out, ref = (torch.as_tensor(np.array(x, dtype=np.float64)) for x in (out, ref))
    return ((out - ref).norm() / ref.norm()).item()


def bwd_emulated(q, k, v, mask, o, lse, g, mm):
    """K4-f32's arithmetic with its five products through ``mm``: p and ds
    stay f32 before their split, as in the kernel."""
    b, tq, h, d = q.shape
    valid = torch.ones(b, k.shape[1], dtype=torch.bool) if mask is None else mask
    any_valid = valid.any(-1)
    valid = valid | ~any_valid[:, None]
    sc = (any_valid.float() * d ** -0.5)[:, None, None, None]
    s = mm("bihd,bjhd->bhij", q, k) * sc
    p = torch.where(valid[:, None, None, :], torch.exp(s - lse.reshape(b, h, tq, 1)), 0.0)
    delta = (g * o).sum(-1).transpose(1, 2)[..., None]
    dv = mm("bhij,bihd->bjhd", p, g)
    ds = p * (mm("bihd,bjhd->bhij", g, v) - delta) * sc
    return mm("bhij,bjhd->bihd", ds, k), mm("bhij,bihd->bjhd", ds, q), dv


def test_split_reconstructs_f32():
    """hi and lo are TF32 values and hi + lo is x to within 2^-21 of |x|
    (the bound is 2^-22: each rounding to nearest leaves half a unit of
    TF32's 11 significant bits), over 13 decades and both signs."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(200_000) * 10.0 ** rng.uniform(-6, 6, 200_000))
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    # to nearest, not truncated: truncation leaves up to a whole unit in hi
    trunc = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
    assert (x - hi).abs().max() < (x - trunc).abs().max()


@pytest.fixture(scope="module")
def attention_case():
    """B2 T40 H2 D24 with a key mask (the second row keeps 23 keys), the
    JAX LSE and gradients (interpret mode) and the plain version's."""
    rng = np.random.default_rng(12)
    q, k, v, g = (rng.standard_normal((2, 40, 2, 24)).astype(np.float32) for _ in range(4))
    mask = np.arange(40)[None, :] < np.array([40, 23])[:, None]
    o, lse = j_flash_mha(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask), block_q=BLOCK,
                         interpret=True, return_lse=True)
    jax_grads = j_flash_mha_bwd(*map(jnp.asarray, (q, k, v, mask)), o, lse, jnp.asarray(g),
                                block_q=BLOCK, block_k=BLOCK, interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v, mask, np.array(o), g)]
    port_lse = ops.attention_lse_reference(t[0], t[1], mask=t[3])
    plain = ops.flash_mha_bwd_reference(*t[:5], port_lse, t[5])
    return t, port_lse, plain, jax_grads


def test_3xtf32_attention_backward_within_the_f32_limit(attention_case):
    t, lse, plain, jax_grads = attention_case
    split_grads = bwd_emulated(*t[:5], lse, t[5], mm_3xtf32)
    for name, out, ref, jref in zip(("dq", "dk", "dv"), split_grads, plain, jax_grads):
        assert rel_l2(out, ref) <= REL_L2_TOL, name
        assert rel_l2(out, jref) <= REL_L2_TOL, name
    pad = ~t[3]  # keys at padded positions: exactly zero dk and dv, as in the kernel
    assert not split_grads[1][pad].any() and not split_grads[2][pad].any()


def test_one_tf32_pass_leaves_the_attention_limit(attention_case):
    t, lse, plain, _ = attention_case
    tf32_grads = bwd_emulated(*t[:5], lse, t[5], mm_tf32)
    assert max(rel_l2(out, ref) for out, ref in zip(tf32_grads, plain)) > REL_L2_TOL


@pytest.fixture(scope="module")
def dense_case():
    """x f32 (37, 96) and a (96, 256) int8 weight with column scales."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((37, 96)).astype(np.float32)
    w = rng.standard_normal((96, 256)).astype(np.float32) * rng.uniform(0.5, 2.0, 256)
    q, scale = ops.quantize_weight(torch.from_numpy(w.astype(np.float32)))
    jax_out = j_int8_dense(jnp.asarray(x), jnp.asarray(q.numpy()), jnp.asarray(scale.numpy()),
                           implementation="pallas", interpret=True)
    return torch.from_numpy(x), q, scale, ops.int8_dense_reference(torch.from_numpy(x), q, scale), jax_out


def test_int8_weight_is_exact_in_tf32(dense_case):
    _, q, _, _, _ = dense_case
    w = torch.arange(-127, 128, dtype=torch.float32)
    assert torch.equal(tf32_rna(w), w) and torch.equal(tf32_rna(q.float()), q.float())


def test_2xtf32_int8_dense_within_the_f32_limit(dense_case):
    x, q, scale, plain, jax_out = dense_case
    hi, lo = split(x)
    out = (hi @ q.float() + lo @ q.float()) * scale
    assert rel_l2(out, plain) <= REL_L2_TOL
    assert rel_l2(out, jax_out) <= REL_L2_TOL


def test_one_tf32_pass_leaves_the_dense_limit(dense_case):
    x, q, scale, plain, _ = dense_case
    assert rel_l2((tf32_rna(x) @ q.float()) * scale, plain) > REL_L2_TOL
