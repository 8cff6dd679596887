"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; every test skips where there is no CUDA device. These cover
edge shapes that chip_smoke.py's slice shapes do not: batch > 1, lengths
that are not a multiple of the tiles, narrow channels, other head dims,
fully masked leading and middle key tiles, a batch row with no valid key,
Tq != Tk, head depths that are not a multiple of 8, both of K3's query
tiles, int8 products with a ragged last row tile and leading batch
dimensions; and the attention backward (K3's LSE, K4, gradients through
``mha``), also at the training slice's shapes, exactly zero dk and dv at
masked keys, bit-equal reruns, and the kernels without a backward refusing
a gradient;
K6's four variants at both query tiles, and remat gradients on the card.
On the GPU machine (no jax there, so the suite's conftest cannot load):

    python3 -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance, as in chip_smoke.py: relative l2 error within 2^-6 (kernel and
plain version round intermediates to bf16 at different points, ~0.3-0.6 %;
a dropped bias or snake alpha costs 8 % or more at the scales drawn here,
alphas U(0.5, 2) and biases N(0, 0.5)), and no element off by more than
2^-5 of the output's largest magnitude.
"""

import math

import pytest
import torch

from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.kernels import launches, reset_launches
from edm_tts_tpu_torch.ops.decoder_block import phase_weights

pytestmark = pytest.mark.gpu

REL_L2_TOL = 2.0 ** -6
MAX_ABS_TOL = 2.0 ** -5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    out, ref = out.float(), ref.float()
    rel = ((out - ref).norm() / ref.norm()).item()
    err = (out - ref).abs().max().item()
    assert rel <= REL_L2_TOL and err <= MAX_ABS_TOL * ref.abs().max().item(), (rel, err)


def _alpha(c, dev, gen):
    return 0.5 + 1.5 * torch.rand(c, generator=gen, device=dev)


def _bias(c, dev, gen):
    return 0.5 * torch.randn(c, generator=gen, device=dev)


def _resunit_params(c, dev, gen):
    """(alpha1, w7, b7, alpha2, w1, b1) as K1 takes them."""
    def u(*shape, bound):
        return ((torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound).bfloat16()

    return (_alpha(c, dev, gen), u(7, c, c, bound=(7 * c) ** -0.5), _bias(c, dev, gen),
            _alpha(c, dev, gen), u(1, c, c, bound=c ** -0.5), _bias(c, dev, gen))


@pytest.mark.parametrize("b,t,c,dil", [
    (2, 37, 16, 1), (3, 130, 64, 9), (1, 5, 96, 3), (2, 333, 768, 3),
    # the tail blocks' units on the masked decode of a 500-frame canvas
    *((1, 80008, 192, d) for d in (1, 3, 9)), *((1, 160016, 96, d) for d in (1, 3, 9)),
])
def test_resunit_kernel_matches_plain(dev, b, t, c, dil):
    gen = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(b, t, c, generator=gen, device=dev).bfloat16()
    p = _resunit_params(c, dev, gen)
    reset_launches()
    out = ops.fused_residual_unit(x, *p, dil)
    assert launches["resunit"] == 1
    _check(out, ops.resunit_reference(x, *p, dilation=dil))


@pytest.mark.parametrize("b,t,s,cin,cout", [(2, 21, 2, 32, 16), (1, 70, 4, 64, 32), (3, 9, 2, 16, 96)])
def test_decoder_block_kernel_matches_plain(dev, b, t, s, cin, cout):
    gen = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(b, t, cin, generator=gen, device=dev).bfloat16()
    a0 = _alpha(cin, dev, gen)
    wt = (torch.rand(2 * s, cin, cout, generator=gen, device=dev) * 2 - 1) * (2 * s * cout) ** -0.5
    w3 = phase_weights(wt.bfloat16(), s).contiguous()
    bias3 = _bias(cout, dev, gen).repeat(s)
    rus = [_resunit_params(cout, dev, gen) for _ in range(3)]
    reset_launches()
    out = ops.fused_decoder_block(x, a0, w3, bias3, rus, s)
    assert launches == {"resunit": 3, "decoder_block": 1, "attention": 0, "attention_bwd": 0,
                        "int8_dense": 0, "attn_variants": 0}
    _check(out, ops.decoder_block_reference(x, a0, w3, bias3, rus, stride=s))


@pytest.mark.parametrize("b,tq,tk,h,d", [(2, 37, 37, 3, 24), (1, 130, 130, 2, 64), (2, 64, 200, 4, 8),
                                         (1, 5, 70, 1, 48)])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_kernel_matches_plain(dev, b, tq, tk, h, d, masked):
    gen = torch.Generator(device=dev).manual_seed(tq + tk + d)
    q = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, tk, h, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    mask = None
    if masked:  # ragged lengths, and the first 64-key tile fully masked in row 0
        pos = torch.arange(tk, device=dev)[None, :]
        mask = pos < torch.tensor([[tk - 3]] + [[tk]] * (b - 1), device=dev)
        if tk > 65:
            mask[0, :64] = False
    reset_launches()
    out = ops.flash_mha(q, k, v, mask=mask)
    assert launches["attention"] == 1
    _check(out, ops.mha_reference(q, k, v, mask=mask))


def test_attention_kernel_row_without_valid_keys_takes_the_mean_of_v(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 101, 8, 24, generator=gen, device=dev).bfloat16() for _ in range(3))
    mask = torch.zeros(2, 101, dtype=torch.bool, device=dev)
    mask[0, :90] = True  # batch row 1 has no valid key at all
    out = ops.flash_mha(q, k, v, mask=mask)
    _check(out, ops.mha_reference(q, k, v, mask=mask))
    _check(out[1], v[1].float().mean(0, keepdim=True).expand(101, 8, 24))


@pytest.mark.parametrize("lead,k,n", [
    ((1,), 32, 128), ((129,), 384, 384), ((662,), 1024, 4096), ((1382,), 192, 384),
    ((2648,), 1024, 4096), ((65,), 4096, 1024), ((2, 77), 384, 1536), ((3, 662), 1024, 8192),
])
def test_int8_dense_kernel_matches_plain(dev, lead, k, n):
    gen = torch.Generator(device=dev).manual_seed(k + n)
    x = torch.randn(*lead, k, generator=gen, device=dev).bfloat16()
    w = torch.randn(k, n, generator=gen, device=dev) * (0.5 + 1.5 * torch.rand(n, generator=gen, device=dev))
    q, scale = ops.quantize_weight(w)
    reset_launches()
    out = ops.int8_dense(x, q, scale)
    assert launches["int8_dense"] == 1 and out.shape == (*lead, n) and out.dtype == torch.bfloat16
    _check(out, ops.int8_dense_reference(x, q, scale))


def test_w8a8_on_the_card_matches_the_cpu(dev):
    """w8a8 is plain PyTorch (``torch._int_mm`` on the card, an int32 matmul
    on the CPU): the integer products are exact, so both sides agree."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(129, 384, generator=gen, device=dev).bfloat16()
    q, scale = ops.quantize_weight(torch.randn(384, 1536, generator=gen, device=dev))
    reset_launches()
    out = ops.int8_dense(x, q, scale, implementation="w8a8")
    assert launches["int8_dense"] == 0
    _check(out, ops.int8_dense(x.cpu(), q.cpu(), scale.cpu(), implementation="w8a8").to(dev))


def test_qlinear_runs_k5_and_adds_the_bias_after(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn(256, 64, generator=gen, device=dev)  # nn.Linear layout (out, in)
    bias = _bias(256, dev, gen).bfloat16()
    x = torch.randn(3, 10, 64, generator=gen, device=dev).bfloat16()
    layer = ops.QLinear.from_weight(w, bias)
    reset_launches()
    out = layer(x)
    assert launches["int8_dense"] == 1
    _check(out, ops.int8_dense_reference(x, layer.kernel_q, layer.kernel_scale) + bias)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, 8, 32, device=dev)
    p = _resunit_params(32, dev, gen)
    with pytest.raises(ValueError):  # f32 input
        ops.fused_residual_unit(x, *p, 1)
    with pytest.raises(ValueError):  # C % 16 != 0
        ops.fused_residual_unit(torch.randn(1, 8, 24, device=dev).bfloat16(),
                                *_resunit_params(24, dev, gen), 1)
    with pytest.raises(ValueError):  # w7 not laid out as the kernel takes it
        ops.fused_residual_unit(x.bfloat16(), p[0], p[1].float(), *p[2:], 1)
    q = torch.randn(1, 8, 2, 80, device=dev).bfloat16()
    with pytest.raises(ValueError):  # D > 64
        ops.flash_mha(q, q, q)
    with pytest.raises(ValueError, match="xla"):  # no setting moves mha off the kernels
        ops.mha(q[..., :64].contiguous(), q[..., :64].contiguous(), q[..., :64].contiguous(),
                implementation="xla")
    wq, scale = ops.quantize_weight(torch.randn(64, 256, device=dev))
    xb = torch.randn(5, 64, device=dev).bfloat16()
    with pytest.raises(ValueError):  # f32 activations
        ops.int8_dense(xb.float(), wq, scale)
    with pytest.raises(ValueError):  # N % 128 != 0
        ops.int8_dense(xb, wq[:, :192].contiguous(), scale[:192].contiguous())
    with pytest.raises(ValueError):  # a row start that is not 16-byte aligned
        ops.int8_dense(torch.randn(5 * 64 + 1, device=dev).bfloat16()[1:].view(5, 64), wq, scale)


def _k4_case(dev, b, t, h, d, lens, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16() for _ in range(4))
    mask = None
    if lens is not None:
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    return q, k, v, g, mask


# the s2a training micro-batch, a masked ragged batch and the t2s canvas
K4_SHAPES = [(8, 768, 16, 64, None), (4, 701, 8, 24, (701, 650, 512, 97)),
             (4, 1382, 8, 24, (1382, 1100, 700, 64)), (2, 37, 3, 40, (37, 5)),
             (1, 130, 2, 64, (70,))]


@pytest.mark.parametrize("b,t,h,d,lens", K4_SHAPES)
def test_attention_lse_and_backward_kernels_match_plain(dev, b, t, h, d, lens):
    q, k, v, g, mask = _k4_case(dev, b, t, h, d, lens, seed=t + d)
    reset_launches()
    o, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (b * h, t) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ops.attention_lse_reference(q, k, mask=mask),
                               rtol=0, atol=1e-4)
    _check(o, ops.mha_reference(q, k, v, mask=mask))
    out = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
    assert launches["attention"] == 1 and launches["attention_bwd"] == 1
    ref = ops.flash_mha_bwd_reference(q, k, v, mask, o, lse, g)
    for a, r in zip(out, ref):
        _check(a, r)
    if mask is not None:  # keys at padded positions: exactly zero dk and dv
        pad = ~mask
        assert not out[1][pad].any() and not out[2][pad].any()


def test_attention_backward_row_without_valid_keys(dev):
    """K3 and K4 count every key with score 0 in a row with no valid key:
    dq = dk = 0 there and dv is the uniform share of dO, what autograd
    through the plain version gives."""
    q, k, v, g, _ = _k4_case(dev, 2, 101, 8, 24, None, seed=5)
    mask = torch.zeros(2, 101, dtype=torch.bool, device=dev)
    mask[0, :90] = True
    o, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
    torch.testing.assert_close(lse[8:], torch.full_like(lse[8:], math.log(101.0)),
                               rtol=0, atol=1e-4)
    dq, dk, dv = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
    torch.cuda.synchronize()
    assert not dq[1].any() and not dk[1].any()
    _check(dv[1], g[1].float().mean(0, keepdim=True).expand(101, 8, 24))
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    (ops.mha_reference(qf, kf, vf, mask=mask) * g.float()).sum().backward()
    for a, r in zip((dq, dk, dv), (qf.grad, kf.grad, vf.grad)):
        _check(a[:1], r[:1])


# (B, Tq, Tk, H, D, per batch row the key ranges that count or None, the
# query tile the wrapper picks on an H100): what the redesigned K3/K4 add:
# fully masked key tiles in the middle of a row, Tq != Tk, a D that is not
# a multiple of 8 (padded by the wrappers), both query tiles, and rows with
# fewer than 64 valid keys (the tiles past them are skipped; their dk and
# dv must be exactly 0)
TILE_CASES = {
    "middle tiles masked": (2, 300, 300, 4, 64, (((0, 64), (128, 192), (256, 300)),
                                                ((0, 200),)), 64),
    "middle tiles masked D24": (2, 300, 300, 4, 24, (((0, 10), (250, 300)), ((70, 300),)), 64),
    "Tq < Tk": (2, 100, 230, 3, 64, (((0, 230),), ((0, 150),)), 64),
    "Tq > Tk": (1, 200, 70, 2, 24, None, 64),
    "D20 padded": (2, 130, 130, 4, 20, (((0, 130),), ((0, 77),)), 64),
    "D5 padded": (1, 70, 90, 2, 5, None, 64),
    "block_q 128": (4, 600, 600, 16, 64, (((0, 600),), ((0, 411),), ((0, 37),), ((90, 600),)),
                    128),
    "block_q 128 D24": (8, 333, 333, 12, 24, None, 128),
    "ragged under 64 keys": (2, 200, 200, 2, 64, (((0, 37),), ((0, 150),)), 64),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_attention_tiles_forward_and_backward_match_plain(dev, case):
    b, tq, tk, h, d, ranges, block_q = TILE_CASES[case]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ops.attention.attention_query_tile(b, h, tq, sms) == block_q
    gen = torch.Generator(device=dev).manual_seed(tq + tk + d)
    q, g = (torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, tk, h, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    mask = None
    if ranges is not None:
        mask = torch.zeros(b, tk, dtype=torch.bool, device=dev)
        for i, row in enumerate(ranges):
            for lo, hi in row:
                mask[i, lo:hi] = True
    reset_launches()
    out = ops.flash_mha(q, k, v, mask=mask)
    o, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.equal(out, o)  # the LSE changes nothing else
    _check(o, ops.mha_reference(q, k, v, mask=mask))
    torch.testing.assert_close(lse, ops.attention_lse_reference(q, k, mask=mask),
                               rtol=0, atol=1e-4)
    grads = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
    assert launches["attention"] == 2 and launches["attention_bwd"] == 1
    for a, r in zip(grads, ops.flash_mha_bwd_reference(q, k, v, mask, o, lse, g)):
        assert a.shape == r.shape
        _check(a, r)
    if mask is not None:
        assert not grads[1][~mask].any() and not grads[2][~mask].any()


def test_attention_backward_is_deterministic(dev):
    """dq, dk and dv sum in a fixed order (no atomics): two runs agree to
    the bit."""
    q, k, v, g, mask = _k4_case(dev, 4, 701, 8, 24, (701, 650, 512, 97), seed=9)
    o, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
    first = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
    second = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
    for a, r in zip(first, second):
        assert torch.equal(a, r)


@pytest.mark.parametrize("masked", [False, True])
def test_mha_gradient_on_the_card_goes_through_k4(dev, masked):
    """The repaired fault: gradients through ``mha`` on CUDA exist and match
    autograd through the plain version (in f32, on the same bf16 inputs);
    without a gradient ``mha`` launches K3 alone."""
    q, k, v, g, mask = _k4_case(dev, 2, 130, 4, 64, (130, 77) if masked else None, seed=11)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    reset_launches()
    (ops.mha(qs, ks, vs, mask=mask).float() * g.float()).sum().backward()
    assert launches["attention"] == 1 and launches["attention_bwd"] == 1
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    (ops.mha_reference(qf, kf, vf, mask=mask) * g.float()).sum().backward()
    for a, r in zip((qs.grad, ks.grad, vs.grad), (qf.grad, kf.grad, vf.grad)):
        assert a is not None and a.dtype == torch.bfloat16
        _check(a, r)
    reset_launches()
    with torch.no_grad():
        ops.mha(qs, ks, vs, mask=mask)
    ops.mha(q, k, v, mask=mask)
    assert launches["attention"] == 2 and launches["attention_bwd"] == 0


def test_kernels_without_a_backward_refuse_a_gradient(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, 40, 32, generator=gen, device=dev).bfloat16().requires_grad_()
    p = _resunit_params(32, dev, gen)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_residual_unit(x, *p, 1)
    w3 = phase_weights(torch.randn(4, 32, 16, generator=gen, device=dev).bfloat16(), 2).contiguous()
    rus = [_resunit_params(16, dev, gen) for _ in range(3)]
    args = (_alpha(32, dev, gen), w3, _bias(16, dev, gen).repeat(2), rus, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_decoder_block(x, *args)
    wq, scale = ops.quantize_weight(torch.randn(32, 128, generator=gen, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.int8_dense(x, wq, scale)
    with torch.no_grad():  # under no_grad they run, detached
        assert not ops.fused_residual_unit(x, *p, 1).requires_grad
        assert not ops.fused_decoder_block(x, *args).requires_grad
        assert not ops.int8_dense(x, wq, scale).requires_grad


@pytest.mark.parametrize("b,t,h,d", [(2, 37, 3, 24), (1, 130, 2, 64), (2, 701, 8, 24), (1, 5, 1, 40)])
@pytest.mark.parametrize("variant", ops.attn_variants.VARIANTS)
@pytest.mark.parametrize("block_q", ops.attn_variants.BLOCK_Q)
def test_attn_variant_kernel_matches_plain(dev, b, t, h, d, variant, block_q):
    gen = torch.Generator(device=dev).manual_seed(t + d)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16() for _ in range(3))
    reset_launches()
    out = ops.attn_variant(q, k, v, variant=variant, block_q=block_q)
    assert launches["attn_variants"] == 1
    _check(out, ops.attn_variant_reference(q, k, v, variant=variant))


def test_attn_variant_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 8, 2, 24, device=dev).bfloat16()
    with pytest.raises(ValueError):  # f32
        ops.attn_variant(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):  # D > 64
        big = torch.randn(1, 8, 2, 80, device=dev).bfloat16()
        ops.attn_variant(big, big, big)
    with pytest.raises(ValueError):  # keys of another length
        ops.attn_variant(q, q[:, :4].contiguous(), q[:, :4].contiguous())
    with pytest.raises(ValueError):
        ops.attn_variant(q, q, q, variant="nomax")


@pytest.mark.parametrize("policy", ["full", "mha", "dots"])
def test_remat_gradients_on_the_card(dev, policy):
    """A small s2a under bf16 autocast with dropout 0.1 from a CUDA
    generator: each remat policy gives the gradient of no remat, leaves the
    generator in the same state, and launches K3 twice per block under
    "full" and once under "mha" and "dots"."""
    import dataclasses

    from edm_tts_tpu_torch.convert import init_random_weights
    from edm_tts_tpu_torch.models.codec import CodecConfig
    from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig

    cfg = S2AConfig(hidden_size=64, num_semantic_tokens=8, encoder_num_heads=2,
                    encoder_num_layers=4, injection_layers=(1, 2), encoder_ff_dropout=0.1,
                    encoder_conv_dropout=0.1,
                    codec=CodecConfig(encoder_dim=4, decoder_dim=64, n_codebooks=4,
                                      codebook_size=16, codebook_dim=4))
    model = InjectionConformer(cfg, device=dev)
    init_random_weights(model, 0)
    model.acoustic_model.requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(1)
    ac = torch.randint(0, 16, (2, 4, 100), generator=gen, device=dev)
    sem = torch.randint(0, 8, (2, 100), generator=gen, device=dev)
    results = {}
    for name in (None, policy):
        model.cfg = dataclasses.replace(cfg, gradient_checkpointing=name is not None,
                                        remat_policy=name or cfg.remat_policy)
        model.zero_grad(set_to_none=True)
        g = torch.Generator(device=dev).manual_seed(5)
        reset_launches()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = model.forward_train(ac, sem, generator=g)["loss"]
        loss.backward()
        torch.cuda.synchronize()
        grad = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
        results[name] = (grad, g.get_state(), dict(launches))
    (g0, s0, c0), (g1, s1, c1) = results[None], results[policy]
    assert ((g1 - g0).norm() / g0.norm()).item() <= 1e-3
    assert torch.equal(s0, s1)
    assert c0["attention"] == 4 and c0["attention_bwd"] == 4
    assert c1["attention"] == (8 if policy == "full" else 4) and c1["attention_bwd"] == 4
