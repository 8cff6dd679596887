"""Plain versions of the port's kernels K1-K3 against the JAX package.

Each CUDA kernel (edm_tts_tpu_torch/csrc) has a plain PyTorch version in
the same module; on a CPU tensor the kernel's wrapper takes it. Here that
version is held against the JAX reference composition and against the
Pallas kernel run as the JAX package's own tests run it on the CPU
(interpret mode). The kernels themselves are compared with these plain
versions on the card by chip_smoke.py.

Tolerances: against the f32 JAX composition, atol/rtol 1e-4 (same math,
other summation order). Against the interpret-mode residual-unit and
decoder-block kernels, the tolerances of tests/test_pallas_resunit.py
(2e-2) and tests/test_pallas_decoder_block.py (6e-2): those kernels cast
their matmul operands to bf16. The attention kernel keeps f32 operands in
f32, so it is held at 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from edm_tts_tpu.ops.attention import mha_reference as j_mha_reference
from edm_tts_tpu.ops.pallas_attention import flash_mha as j_flash_mha
from edm_tts_tpu.ops.pallas_decoder_block import _block_ref, _phase_weights
from edm_tts_tpu.ops.pallas_decoder_block import _fused_forward as j_block_kernel
from edm_tts_tpu.ops.pallas_resunit import _fused_forward as j_resunit_kernel
from edm_tts_tpu.ops.pallas_resunit import _resunit_ref
from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.kernels import launches, reset_launches
from edm_tts_tpu_torch.ops.decoder_block import phase_weights

TOL = dict(atol=1e-4, rtol=1e-4)


def _resunit_params(rng, c):
    return [
        (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32),
        (rng.standard_normal((7, c, c)) * 0.05).astype(np.float32),
        (rng.standard_normal(c) * 0.01).astype(np.float32),
        (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32),
        (rng.standard_normal((1, c, c)) * 0.05).astype(np.float32),
        (rng.standard_normal(c) * 0.01).astype(np.float32),
    ]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_resunit_plain_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    c, t = 32, 150
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    p = _resunit_params(rng, c)
    port = ops.fused_residual_unit(torch.from_numpy(x), *_t(p), dilation).numpy()
    np.testing.assert_allclose(port, np.asarray(_resunit_ref(jnp.asarray(x), *_j(p), dilation=dilation)),
                               **TOL)
    with pltpu.force_tpu_interpret_mode():
        kernel = j_resunit_kernel(jnp.asarray(x), *_j(p), dilation=dilation, block_t=64)
    np.testing.assert_allclose(port, np.asarray(kernel), atol=2e-2, rtol=2e-2)


def _block_params(rng, cin, cout, s):
    alpha0 = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    wt = (rng.standard_normal((2 * s, cin, cout)) * 0.2).astype(np.float32)
    bt = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    rus = [_resunit_params(rng, cout) for _ in range(3)]
    return alpha0, wt, bt, rus


def _phase_args(alpha0, wt, bt, s):
    """The transposed conv as the port's K2 takes it: phase weights, tiled bias."""
    bt = torch.from_numpy(bt)
    return torch.from_numpy(alpha0), phase_weights(torch.from_numpy(wt), s), bt.repeat(s)


@pytest.mark.parametrize("s,cin,cout,t", [(2, 24, 12, 61), (4, 16, 8, 40)])
def test_decoder_block_plain_matches_jax(s, cin, cout, t):
    rng = np.random.default_rng(s)
    alpha0, wt, bt, rus = _block_params(rng, cin, cout, s)
    x = (rng.standard_normal((2, t, cin)) * 0.5).astype(np.float32)
    port = ops.fused_decoder_block(torch.from_numpy(x), *_phase_args(alpha0, wt, bt, s),
                                   [_t(r) for r in rus], s).numpy()
    assert port.shape == (2, t * s, cout)
    j_args = (jnp.asarray(x), jnp.asarray(alpha0), jnp.asarray(wt), jnp.asarray(bt),
              tuple(tuple(_j(r)) for r in rus))
    np.testing.assert_allclose(port, np.asarray(_block_ref(*j_args, stride=s)), **TOL)
    with pltpu.force_tpu_interpret_mode():
        kernel = j_block_kernel(*j_args, stride=s, block_f=8)
    np.testing.assert_allclose(port, np.asarray(kernel), atol=6e-2, rtol=6e-2)


@pytest.mark.parametrize("s", [2, 4])
def test_phase_weights_match_jax(s):
    rng = np.random.default_rng(s)
    wt = rng.standard_normal((2 * s, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(phase_weights(torch.from_numpy(wt), s).numpy(),
                                  np.asarray(_phase_weights(jnp.asarray(wt), s, 5, 3)))


@pytest.mark.parametrize("d", [24, 64])
@pytest.mark.parametrize("valid_keys", [None, (23, 37), (23, 0)])
def test_attention_plain_matches_jax(d, valid_keys):
    """Key masks: none; ragged (23 and all 37 keys valid); a batch row with no
    valid key, which every version answers with the mean of V."""
    rng = np.random.default_rng(d + len(valid_keys or ()))
    b, t, h = 2, 37, 3
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = None
    if valid_keys is not None:
        mask = np.arange(t)[None, :] < np.array(valid_keys)[:, None]
    port = ops.flash_mha(*_t((q, k, v)), mask=None if mask is None else torch.from_numpy(mask)).numpy()
    jmask = None if mask is None else jnp.asarray(mask)
    np.testing.assert_allclose(port, np.asarray(j_mha_reference(*_j((q, k, v)), mask=jmask)), **TOL)
    kernel = j_flash_mha(*_j((q, k, v)), mask=jmask, block_q=16, interpret=True)
    np.testing.assert_allclose(port, np.asarray(kernel), **TOL)
    if valid_keys == (23, 0):
        np.testing.assert_allclose(port[1], np.broadcast_to(v[1].mean(0), port[1].shape), **TOL)


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    rng = np.random.default_rng(7)
    reset_launches()
    x = torch.from_numpy(rng.standard_normal((1, 20, 16)).astype(np.float32))
    p = _t(_resunit_params(rng, 16))
    torch.testing.assert_close(ops.fused_residual_unit(x, *p, 3),
                               ops.resunit_reference(x, *p, dilation=3), rtol=0, atol=0)
    alpha0, wt, bt, rus = _block_params(rng, 16, 16, 2)
    args = (x, *_phase_args(alpha0, wt, bt, 2), [_t(r) for r in rus])
    torch.testing.assert_close(ops.fused_decoder_block(*args, 2),
                               ops.decoder_block_reference(*args, stride=2), rtol=0, atol=0)
    q = x.reshape(1, 20, 2, 8)
    torch.testing.assert_close(ops.mha(q, q, q), ops.mha_reference(q, q, q), rtol=0, atol=0)
    wq, scale = ops.quantize_weight(torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32)))
    torch.testing.assert_close(ops.int8_dense(x, wq, scale), ops.int8_dense_reference(x, wq, scale),
                               rtol=0, atol=0)
    assert launches == {"resunit": 0, "decoder_block": 0, "attention": 0, "attention_bwd": 0,
                        "int8_dense": 0}
