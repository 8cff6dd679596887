"""What the attention kernels' wrappers decide on the host, held on the CPU.

K3 and K4 (edm_tts_tpu_torch/csrc/attention.cu, attention_bwd.cu) copy
64-row tiles with the card's tensor-memory accelerator, whose rows are whole
16-byte units, so they take a head depth D % 8 == 0; for any other D the
wrappers zero-pad q, k, v (and o, dO) to the next multiple of 8, scale the
scores by the true D and slice the outputs. K3's query tile (64 or 128 rows
per block) is a pure function of the launch's B, H and Tq. Both rules run
here on the plain versions, which take the padded tensors as the kernels
do; the padded path is also held against the JAX package's reference
attention and its gradient.

Tolerances: padded against unpadded plain versions, atol/rtol 1e-6 (zero
lanes add exact zeros to f32 sums; only the scale's rounding may differ);
against the JAX composition in f32, atol/rtol 1e-4, as
tests/test_torch_kernels_ref.py holds the plain attention to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.ops.attention import mha_reference as j_mha_reference
from edm_tts_tpu_torch.ops.attention import (
    H100_SMS,
    attention_lse_reference,
    attention_query_tile,
    flash_mha_bwd_reference,
    mha_reference,
    pad_depth,
    padded_depth,
)

EXACT = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,h,tq,want", [
    (1, 8, 604, 64),     # one request's t2s canvas: 80 blocks at 64 rows
    (1, 8, 101, 64),     # the length predictor
    (1, 16, 650, 64),    # one request's s2a canvas
    (4, 8, 701, 64),     # a ragged batch: 192 blocks at 128 rows, under two per SM
    (4, 16, 662, 128),   # the served batch's s2a canvas
    (4, 8, 1382, 128),   # the served batch's t2s canvas
    (8, 16, 768, 128),   # the s2a training micro-batch
    (32, 16, 1408, 128),  # the t2s ablation shape
])
def test_query_tile_at_the_ports_shapes(b, h, tq, want):
    assert attention_query_tile(b, h, tq) == want


def test_query_tile_needs_two_blocks_per_sm_at_128_rows():
    assert H100_SMS == 132
    # B8 H16 T768: 8 * 16 * 6 = 768 blocks of 128 rows
    assert attention_query_tile(8, 16, 768, sms=384) == 128
    assert attention_query_tile(8, 16, 768, sms=385) == 64
    # 2 * 132 = 264 blocks: B1 H8 at 33 tiles of 128 rows (T 4097-4224)
    assert attention_query_tile(1, 8, 4097) == 128
    assert attention_query_tile(1, 8, 4096) == 64
    for b, h, tq in ((1, 1, 1), (3, 5, 777), (64, 16, 2500)):
        assert attention_query_tile(b, h, tq) in (64, 128)


@pytest.mark.parametrize("d,want", [(1, 8), (8, 8), (20, 24), (24, 24), (40, 40), (44, 48),
                                    (63, 64), (64, 64)])
def test_padded_depth_is_the_next_multiple_of_8(d, want):
    assert padded_depth(d) == want
    x = torch.randn(2, 3, 1, d)
    xp = pad_depth(x, padded_depth(d))
    assert xp.shape == (2, 3, 1, want) and torch.equal(xp[..., :d], x)
    assert not xp[..., d:].any()
    assert pad_depth(x, d) is x


def _inputs(d: int, masked: bool, seed: int):
    rng = np.random.default_rng(seed)
    b, tq, tk, h = 2, 37, 53, 3
    q, g = (rng.standard_normal((b, tq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, tk, h, d)).astype(np.float32) for _ in range(2))
    mask = np.arange(tk)[None, :] < np.array([[41], [tk]]) if masked else None
    return q, k, v, g, mask


@pytest.mark.parametrize("d", [5, 20, 44])
@pytest.mark.parametrize("masked", [False, True])
def test_depth_padding_keeps_the_forward_and_the_lse(d, masked):
    q, k, v, _, mask = _inputs(d, masked, seed=d)
    q_t, k_t, v_t = (torch.from_numpy(x) for x in (q, k, v))
    mask_t = None if mask is None else torch.from_numpy(mask)
    dp = padded_depth(d)
    qp, kp, vp = (pad_depth(x, dp) for x in (q_t, k_t, v_t))
    out = mha_reference(qp, kp, vp, mask=mask_t, scale=d ** -0.5)
    assert out.shape == (*q.shape[:3], dp) and not out[..., d:].any()
    torch.testing.assert_close(out[..., :d], mha_reference(q_t, k_t, v_t, mask=mask_t), **EXACT)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = j_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask)
    np.testing.assert_allclose(out[..., :d].numpy(), np.asarray(ref), **TOL)
    torch.testing.assert_close(attention_lse_reference(qp, kp, mask=mask_t, scale=d ** -0.5),
                               attention_lse_reference(q_t, k_t, mask=mask_t), **EXACT)
    # the padded depth's own scale is a different function
    wrong = mha_reference(qp, kp, vp, mask=mask_t)[..., :d]
    assert (wrong - out[..., :d]).abs().max() > 1e-3


@pytest.mark.parametrize("d", [5, 20, 44])
@pytest.mark.parametrize("masked", [False, True])
def test_depth_padding_keeps_the_gradients(d, masked):
    q, k, v, g, mask = _inputs(d, masked, seed=100 + d)
    q_t, k_t, v_t, g_t = (torch.from_numpy(x) for x in (q, k, v, g))
    mask_t = None if mask is None else torch.from_numpy(mask)
    o = mha_reference(q_t, k_t, v_t, mask=mask_t)
    lse = attention_lse_reference(q_t, k_t, mask=mask_t)
    grads = flash_mha_bwd_reference(q_t, k_t, v_t, mask_t, o, lse, g_t)
    dp = padded_depth(d)
    padded = flash_mha_bwd_reference(*(pad_depth(x, dp) for x in (q_t, k_t, v_t)), mask_t,
                                     pad_depth(o, dp), lse, pad_depth(g_t, dp), scale=d ** -0.5)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(qj, kj, vj):
        return (j_mha_reference(qj, kj, vj, mask=jmask) * jnp.asarray(g)).sum()

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for p, r, j in zip(padded, grads, jgrads):
        assert p.shape[-1] == dp and not p[..., d:].any()
        torch.testing.assert_close(p[..., :d], r, **EXACT)
        np.testing.assert_allclose(p[..., :d].numpy(), np.asarray(j), **TOL)
