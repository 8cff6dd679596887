"""The port's weight-only int8 dense (ops/qdense.py) against edm_tts_tpu's.

Same inputs from numpy on both sides, f32 on the CPU, where ``int8_dense``
takes its plain version (kernel K5 runs only on the card:
tests/test_torch_kernels_gpu.py). Quantization: bit-exact. Products: atol
1e-5 against the JAX ``"xla"`` branch and the w8a8 path (same arithmetic,
another summation order), 1e-4 against the Pallas kernel in interpret mode
(as tests/test_qdense.py holds it against the ``"xla"`` branch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.ops.qdense import QDense
from edm_tts_tpu.ops.qdense import int8_dense as j_int8_dense
from edm_tts_tpu.ops.qdense import quantizable_shape as j_quantizable_shape
from edm_tts_tpu.ops.qdense import quantize_weight as j_quantize_weight
from edm_tts_tpu_torch.ops import (
    QLinear,
    int8_dense,
    int8_dense_reference,
    quantizable_shape,
    quantize_weight,
)


def _weights(k, n, seed=0):
    """Column magnitudes spread over 0.05-1, a zero column, and entries at
    exact .5 ties of ``w / scale`` (col 5: amax 127 -> scale 1)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * rng.uniform(0.05, 1.0, n).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = rng.integers(-40, 40, k) + 0.5
    w[0, 5] = 127.0
    return w


def test_quantize_weight_is_bit_exact_against_jax():
    w = _weights(64, 256)
    q, scale = quantize_weight(torch.from_numpy(w))
    jq, jscale = j_quantize_weight(jnp.asarray(w))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert scale[3] == 1.0 and not q[:, 3].any()
    # the ties round half to even: 2.5 -> 2, -3.5 -> -4
    ties = w[:, 5]
    np.testing.assert_array_equal(q[:, 5].numpy(), np.round(ties).astype(np.int8))
    assert (np.abs(ties - np.round(ties)) == 0.5).sum() > 50


@pytest.mark.parametrize("m,k,n", [(7, 64, 256), (33, 96, 128), (130, 64, 384)])
def test_int8_dense_plain_matches_jax_xla(m, k, n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    q, scale = (np.array(a) for a in j_quantize_weight(jnp.asarray(_weights(k, n))))
    ref = j_int8_dense(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), implementation="xla")
    out = int8_dense(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale))
    assert out.shape == (2, m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        int8_dense_reference(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale)),
        out)


def test_int8_dense_plain_matches_jax_pallas_interpret():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((33, 96)).astype(np.float32)
    q, scale = (np.array(a) for a in j_quantize_weight(jnp.asarray(_weights(96, 128))))
    ref = j_int8_dense(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                       implementation="pallas", interpret=True)
    out = int8_dense(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_w8a8_matches_jax_w8a8():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    x[2] = 0.0  # a zero row gets activation scale 1
    q, scale = (np.array(a) for a in j_quantize_weight(jnp.asarray(_weights(64, 256))))
    ref = j_int8_dense(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), implementation="w8a8")
    out = int8_dense(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale),
                     implementation="w8a8")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,n", [(64, 256), (96, 128), (128, 96), (48, 128), (128, 8), (192, 384)])
@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_qlinear_gate_and_output_match_jax_qdense(k, n, mode):
    """The gate agrees with JAX's, and a QLinear made from a weight gives
    JAX's QDense (bias added after the product) on the quantized tree."""
    assert quantizable_shape(k, n) == j_quantizable_shape(k, n)
    if not quantizable_shape(k, n):
        return
    rng = np.random.default_rng(4)
    w = _weights(k, n)
    bias = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    jq, jscale = j_quantize_weight(jnp.asarray(w))
    params = {"params": {"kernel_q": jq, "kernel_scale": jscale, "bias": jnp.asarray(bias)}}
    ref = QDense(n, quantize=mode).apply(params, jnp.asarray(x))
    layer = QLinear.from_weight(torch.from_numpy(w).t(), torch.from_numpy(bias), mode)
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_int8_dense_rejects_an_unknown_implementation():
    with pytest.raises(ValueError):
        int8_dense(torch.zeros(2, 32), torch.zeros(32, 128, dtype=torch.int8), torch.ones(128),
                   implementation="pallas")

