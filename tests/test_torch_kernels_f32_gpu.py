"""K3's and K5's f32 kernels against their plain f32 versions, on the card.

Marked ``gpu``; every test skips where there is no CUDA device. On the GPU
machine (no jax there, so the suite's conftest cannot load):

    python3 -m pytest --noconftest -m gpu tests/test_torch_kernels_f32_gpu.py

K3 at f32 (csrc/attention_f32.cu) at the shapes of the f32 path: HuBERT-large
(H16 D64, B1 T150-500 and B4 with the key mask), the t2s canvas (H8 D24,
masked, ragged B4) and the s2a (H16 D64 up to T1250), a batch row with no
valid key, a depth that is not a multiple of 4, and its LSE. K5 at f32
(csrc/qdense_f32.cu) at the 31 shapes of profile_qdense (one request's 14
and a served call's 17) and a ragged last row tile.

Limits, set before the kernels' first run: relative l2 error within 2^-16
and no element off by more than 2^-14 of the output's largest magnitude (an
f32 result differs from another f32 summation order by ~1e-7 to 1e-6; bf16
or TF32 rounding of an operand moves it by ~4e-3 or ~5e-4). Each case shows
that planted faults of the plain version land outside them: an operand
rounded to bf16 or to TF32, the mask ignored, the tail tile dropped, the
scale left out, the last K step dropped.
"""

import pytest
import torch

from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.kernels import f32_launches, launches, reset_launches
from edm_tts_tpu_torch.profile_qdense import CASES as INT8_CASES
from edm_tts_tpu_torch.profile_qdense import SERVED_CASES as SERVED_INT8_CASES

pytestmark = pytest.mark.gpu

REL_L2_TOL = 2.0 ** -16
MAX_ABS_TOL = 2.0 ** -14
LSE_ABS_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref) -> float:
    return ((out.double() - ref.double()).norm() / ref.double().norm()).item()


def _check(out, ref, faults=()):
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == torch.float32 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    rel = _rel(out, ref)
    err = (out - ref).abs().max().item()
    assert rel <= REL_L2_TOL, rel
    assert err <= MAX_ABS_TOL * ref.abs().max().item(), err
    for name, fault in faults:
        assert _rel(fault, ref) > REL_L2_TOL, name


def bf16(x):
    return x.to(torch.bfloat16).float()


def tf32(x):
    """``x`` with its mantissa cut to TF32's 10 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


ATTENTION_CASES = (
    # (B, T, H, D, key lengths or None)
    (1, 150, 16, 64, None),          # HuBERT, a 3 s prompt
    (1, 500, 16, 64, None),          # HuBERT, a 10 s prompt
    (4, 500, 16, 64, (150, 275, 400, 500)),  # HuBERT, a masked batch
    (1, 604, 8, 24, (553,)),         # the t2s canvas
    (4, 701, 8, 24, (701, 650, 512, 97)),
    (1, 650, 16, 64, None),          # s2a
    (1, 1250, 16, 64, (1199,)),
    (2, 77, 4, 20, (77, 3)),         # D not a multiple of 4, a short row
)


@pytest.mark.parametrize("b,t,h,d,lens", ATTENTION_CASES)
def test_attention_f32_matches_plain(dev, b, t, h, d, lens):
    g = torch.Generator(device=dev).manual_seed(t + d)
    q, k, v = (torch.randn(b, t, h, d, generator=g, device=dev) for _ in range(3))
    mask = None
    if lens is not None:
        mask = torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
    reset_launches()
    out, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
    assert f32_launches["attention_f32"] == 1 and launches["attention"] == 0
    ref = ops.mha_reference(q, k, v, mask=mask)
    faults = [("bf16 operands", ops.mha_reference(bf16(q), bf16(k), bf16(v), mask=mask)),
              ("tf32 operands", ops.mha_reference(tf32(q), tf32(k), v, mask=mask))]
    if mask is not None:
        faults.append(("mask ignored", ops.mha_reference(q, k, v)))
    if t % 64:
        cut = t // 64 * 64
        valid = torch.ones(b, t, dtype=torch.bool, device=dev) if mask is None else mask
        tail = valid & (torch.arange(t, device=dev)[None] < cut)
        if (tail.any(-1) == valid.any(-1)).all() and not torch.equal(tail, valid):
            faults.append(("tail tile dropped", ops.mha_reference(q, k, v, mask=tail)))
    _check(out, ref, faults)
    lse_ref = ops.attention_lse_reference(q, k, mask=mask)
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS_TOL
    again = ops.flash_mha(q, k, v, mask=mask)
    assert torch.equal(again, out)  # deterministic


def test_attention_f32_row_without_valid_keys(dev):
    """A batch row with no valid key attends uniformly: the mean of V."""
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 130, 4, 64, generator=g, device=dev) for _ in range(3))
    mask = torch.zeros(2, 130, dtype=torch.bool, device=dev)
    mask[0, :70] = True
    out, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
    _check(out, ops.mha_reference(q, k, v, mask=mask))
    torch.testing.assert_close(out[1], v[1].mean(0, keepdim=True).expand(130, -1, -1),
                               rtol=1e-5, atol=1e-5)
    assert torch.allclose(lse.reshape(2, 4, 130)[1], torch.full((4, 130), float(130)).log().to(dev))


def test_attention_f32_has_no_backward(dev):
    q = torch.randn(1, 64, 4, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        ops.mha(q, q.detach(), q.detach())
    with torch.no_grad():
        assert ops.mha(q, q, q).dtype == torch.float32


@pytest.mark.parametrize("label,m,k,n", INT8_CASES + SERVED_INT8_CASES + (("ragged", 67, 96, 256),))
def test_int8_dense_f32_matches_plain(dev, label, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(k, n, generator=g, device=dev) * (0.5 + 1.5 * torch.rand(n, generator=g, device=dev))
    q8, scale = ops.quantize_weight(w)
    reset_launches()
    out = ops.int8_dense(x, q8, scale)
    assert f32_launches["int8_dense_f32"] == 1 and launches["int8_dense"] == 0
    ref = ops.int8_dense_reference(x, q8, scale)
    faults = [("bf16 x", ops.int8_dense_reference(bf16(x), q8, scale)),
              ("tf32 x", ops.int8_dense_reference(tf32(x), q8, scale)),
              ("scale ignored", x @ q8.float()),
              ("last K step dropped", ops.int8_dense_reference(x[:, :-16], q8[:-16], scale))]
    _check(out, ref, faults)
    assert torch.equal(ops.int8_dense(x, q8, scale), out)
