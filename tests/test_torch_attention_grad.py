"""The attention backward of the port (K4's plain version, K3's LSE and the
gradient of ``mha``) against the JAX package's Pallas kernels.

The Pallas forward and backward run as the JAX package's own tests run
them on the CPU (interpret mode, blocks of 16 so that the ragged T=35 goes
through their padding paths), in f32; the port's plain versions run in f32
on the same numpy inputs. Tolerances: the LSE and ``flash_mha_bwd_reference``
against ``flash_mha_bwd`` (the same arithmetic from the same LSE, another
summation order): atol/rtol 1e-5. Autograd through the port's
``mha_reference`` against ``jax.grad`` of ``flash_mha_diff``: atol 5e-5,
rtol 1e-3, as tests/test_attention.py holds the Pallas gradient to the
JAX reference. Batch rows with no valid key are left out: there the
Pallas VJP and the port differ by design (the port's kernels attend
uniformly, as autograd through its plain version does); the card test
covers them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.ops.pallas_attention import flash_mha as j_flash_mha
from edm_tts_tpu.ops.pallas_attention import flash_mha_bwd as j_flash_mha_bwd
from edm_tts_tpu.ops.pallas_attention import flash_mha_diff as j_flash_mha_diff
from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.kernels import launches, reset_launches

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)
BLOCK = 16

CASES = {  # name: (T, key lengths per batch row or None)
    "unmasked": (24, None),
    "masked": (24, (17, 24)),
    "ragged T35": (35, (30, 35)),
    "padded keys": (24, (16, 24)),
}


def _inputs(t: int, lens, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((2, t, 2, 8)).astype(np.float32) for _ in range(4))
    mask = None if lens is None else np.arange(t)[None, :] < np.array(lens)[:, None]
    return q, k, v, g, mask


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", list(CASES))
def test_lse_and_backward_reference_match_pallas(case):
    t, lens = CASES[case]
    q, k, v, g, mask = _inputs(t, lens, seed=t + len(case))
    o, lse = j_flash_mha(*map(_j, (q, k, v)), mask=_j(mask), block_q=BLOCK, interpret=True,
                         return_lse=True)
    port_o, port_lse = ops.flash_mha(*map(_t, (q, k, v)), mask=_t(mask), return_lse=True)
    np.testing.assert_allclose(port_lse.numpy(), np.asarray(lse)[..., 0], **TOL)
    np.testing.assert_allclose(port_o.numpy(), np.asarray(o), **TOL)

    ref = j_flash_mha_bwd(*map(_j, (q, k, v, mask, o, lse, g)), block_q=BLOCK, block_k=BLOCK,
                          interpret=True)
    reset_launches()
    out = ops.flash_mha_bwd(*map(_t, (q, k, v, mask, o)), _t(lse)[..., 0], _t(g))
    assert launches["attention_bwd"] == 0  # CPU tensors take the plain version
    for name, a, b in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    if case == "padded keys":
        pad = ~mask
        assert not out[1].numpy()[pad].any() and not out[2].numpy()[pad].any()


@pytest.mark.parametrize("case", list(CASES))
def test_mha_gradient_matches_pallas_vjp(case):
    t, lens = CASES[case]
    q, k, v, g, mask = _inputs(t, lens, seed=100 + t + len(case))

    def loss(q, k, v):
        return jnp.sum(j_flash_mha_diff(q, k, v, _j(mask), BLOCK, True) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(_j, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    (ops.mha(tq, tk, tv, mask=_t(mask)) * _t(g)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


def test_backward_reference_equals_autograd_with_a_row_without_keys():
    """The port's own semantics where the Pallas VJP differs: a batch row
    with no valid key attends uniformly, so dq = dk = 0 there and dv is the
    uniform share of dO, as autograd through ``mha_reference`` gives."""
    q, k, v, g, _ = _inputs(24, None, seed=7)
    mask = torch.zeros(2, 24, dtype=torch.bool)
    mask[0, :20] = True
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = ops.mha_reference(tq, tk, tv, mask=mask)
    (o * _t(g)).sum().backward()
    lse = ops.attention_lse_reference(tq.detach(), tk.detach(), mask=mask)
    np.testing.assert_allclose(lse.numpy()[2:], np.log(24.0), rtol=1e-6)
    out = ops.flash_mha_bwd_reference(tq.detach(), tk.detach(), tv.detach(), mask, o.detach(),
                                      lse, _t(g))
    for a, b in zip(out, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(a, b, **TOL)
    assert not out[0][1].any() and not out[1][1].any()
    torch.testing.assert_close(out[2][1], _t(g)[1].mean(0, keepdim=True).expand(24, 2, 8), **TOL)
