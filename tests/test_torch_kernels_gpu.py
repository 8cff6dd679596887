"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; every test skips where there is no CUDA device. These cover
edge shapes that chip_smoke.py's slice shapes do not: batch > 1, lengths
that are not a multiple of the tiles, narrow channels, other head dims,
fully masked leading and middle key tiles, a batch row with no valid key,
Tq != Tk, head depths that are not a multiple of 8, both of K3's query
tiles (chosen and forced), int8 products at every compiled tile with a
ragged last row tile, a half last K step and leading batch dimensions,
bit-equal int8 reruns; and the attention backward (K3's LSE, K4, gradients through
``mha``), also at the training slice's shapes, exactly zero dk and dv at
masked keys, bit-equal reruns, and K5 (no backward) refusing a gradient;
K1's and K2's gradients under autograd (their backward: the plain version's
VJP) against the plain versions', also through a bf16 codec;
K6's four variants at both query tiles, padded head depths (D 8, 20) and
bit-equal reruns; K1 at every N tile of its two products, at T below one
128-row tile and one past it, dilations whose halo is wider than the
sequence or the tile, B > 1 against each row alone, C 16 to 768 and
bit-equal reruns; K2's front at every column tile, ragged frame counts,
tiles across the halves of the phase columns, B > 1 against each row
alone and bit-equal reruns; K1 at the prompt tokenizer's encoder units
(C 64-512, T up to 160160 rows) and B4 rows there against each row alone,
K3 at HuBERT-large's H16 D64 (B1 unmasked, B4 ragged); and remat gradients
on the card.
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


@pytest.mark.parametrize("tile", ops.resunit.RESUNIT_TILES)
@pytest.mark.parametrize("b,t,c,dil", [
    (2, 130, 192, 3),   # two 128-row tiles, the second ragged; 192 channels
    (1, 129, 96, 9),    # one row past a tile; C % 64 != 0
    (2, 5, 384, 1),     # T below one tile
    (1, 300, 768, 50),  # a halo of 150 rows, wider than the 128-row tile
])
def test_resunit_every_tile_matches_plain(dev, tile, b, t, c, dil):
    """Each N tile of the two products, forced, at ragged time and channel
    edges: columns past C and rows past T are never stored, and the zero
    fill outside [0, T) is the conv's padding."""
    gen = torch.Generator(device=dev).manual_seed(t + c)
    x = torch.randn(b, t, c, generator=gen, device=dev).bfloat16()
    p = _resunit_params(c, dev, gen)
    reset_launches()
    out = ops.fused_residual_unit(x, *p, dil, tile=tile)
    assert launches["resunit"] == 1
    _check(out, ops.resunit_reference(x, *p, dilation=dil))


@pytest.mark.parametrize("c", [16, 64, 96, 192, 384, 768])
@pytest.mark.parametrize("t,dil", [(20, 9), (128, 3), (129, 1)])
def test_resunit_batch_rows_do_not_bleed(dev, c, t, dil):
    """B = 3 at the tile the wrapper picks, each row held against that row
    decoded alone: a dilated tap never reads the neighbouring row's frames
    (at T 20 and dil 9 the 27-row halo is wider than the sequence)."""
    gen = torch.Generator(device=dev).manual_seed(c + t)
    x = torch.randn(3, t, c, generator=gen, device=dev).bfloat16()
    p = _resunit_params(c, dev, gen)
    out = ops.fused_residual_unit(x, *p, dil)
    for i in range(3):
        _check(out[i:i + 1], ops.resunit_reference(x[i:i + 1], *p, dilation=dil))


# the codec encoder's units for a 10 s prompt (160160 padded samples): C 64
# at T 160160, C 128 at 80080, C 256 at 20020, C 512 at 4004; no T a
# multiple of the 128-row tile
ENCODER_UNITS = ((64, 160160), (128, 80080), (256, 20020), (512, 4004))


@pytest.mark.parametrize("dil", [1, 3, 9])
@pytest.mark.parametrize("c,t", ENCODER_UNITS)
def test_resunit_encoder_shapes_match_plain(dev, c, t, dil):
    """K1 at the prompt tokenizer's 12 units, at the tile the wrapper picks."""
    gen = torch.Generator(device=dev).manual_seed(c + dil)
    x = torch.randn(1, t, c, generator=gen, device=dev).bfloat16()
    p = _resunit_params(c, dev, gen)
    reset_launches()
    out = ops.fused_residual_unit(x, *p, dil)
    assert launches["resunit"] == 1
    _check(out, ops.resunit_reference(x, *p, dilation=dil))


@pytest.mark.parametrize("c,t", [(64, 40040), (256, 5005), (64, 160160), (128, 80080)])
def test_resunit_encoder_batch_rows_do_not_bleed(dev, c, t):
    """B = 4 on the encoder's widths (a batch of 2.5 s prompts, and the
    batched tokenizer's canvas of 10 s: 4 x 160160 rows at C 64, where the
    row offsets and the tensor maps' extents are largest), each row held
    against that row alone, at every dilation."""
    gen = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn(4, t, c, generator=gen, device=dev).bfloat16()
    p = _resunit_params(c, dev, gen)
    for dil in (1, 3, 9):
        out = ops.fused_residual_unit(x, *p, dil)
        for i in range(4):
            _check(out[i:i + 1], ops.resunit_reference(x[i:i + 1], *p, dilation=dil))


def test_resunit_is_deterministic(dev):
    """No atomics and no split sums: reruns give the same bits at every tile."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 700, 384, generator=gen, device=dev).bfloat16()
    p = _resunit_params(384, dev, gen)
    for tile in ops.resunit.RESUNIT_TILES:
        first = ops.fused_residual_unit(x, *p, 9, tile=tile)
        for _ in range(3):
            assert torch.equal(ops.fused_residual_unit(x, *p, 9, tile=tile), first)
    with pytest.raises(ValueError):
        ops.fused_residual_unit(x, *p, 9, tile=96)  # not compiled


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


def _front_case(dev, b, t, s, cin, cout, seed):
    """x, alpha0, w3, bias3 of a K2 front, drawn as chip_smoke.py draws them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, cin, generator=gen, device=dev).bfloat16()
    wt = (torch.rand(2 * s, cin, cout, generator=gen, device=dev) * 2 - 1) * (2 * s * cout) ** -0.5
    w3 = phase_weights(wt.bfloat16(), s).contiguous()
    return x, _alpha(cin, dev, gen), w3, _bias(cout, dev, gen).repeat(s)


def _front_reference(x, a0, w3, bias3, s):
    b, t, _ = x.shape
    return ops.decoder_block.tconv_phase_reference(x, a0, w3, bias3).reshape(b, t * s, -1)


@pytest.mark.parametrize("tile", ops.decoder_block.DECODER_BLOCK_TILES)
@pytest.mark.parametrize("b,t,s,cin,cout", [
    (1, 1, 2, 32, 16),      # one frame: both neighbours are the zero fill
    (2, 5, 4, 64, 96),      # T below one 128-frame tile
    (1, 129, 2, 192, 192),  # one frame past a tile
    (2, 130, 4, 48, 16),    # C_in % 64 != 0, N 64
    (1, 130, 8, 96, 96),    # s 8: N 768, half 384
])
def test_decoder_block_front_every_tile_matches_plain(dev, tile, b, t, s, cin, cout):
    """K2's front (snake pass + phase product) at each column tile, forced,
    at ragged frame counts and C_out 16 / 96 / 192: the zero fill outside
    [0, T) is the conv's edge, columns past N and rows past T are never
    stored, and each block runs the taps its columns need."""
    x, a0, w3, bias3 = _front_case(dev, b, t, s, cin, cout, t + cin)
    reset_launches()
    out = ops.decoder_block.tconv_phase(x, a0, w3, bias3, s, tile=tile)
    assert launches["decoder_block"] == 1 and launches["resunit"] == 0
    _check(out, _front_reference(x, a0, w3, bias3, s))


@pytest.mark.parametrize("tile,cout", [(64, 96), (128, 96), (256, 96), (64, 16), (128, 48)])
def test_decoder_block_front_tiles_across_the_halves(dev, tile, cout):
    """At s 2 a column tile that straddles half = C_out runs all three taps
    next to tiles that run two: every such layout against the plain version."""
    n = 2 * cout
    taps = [len(ops.decoder_block.phase_taps(n0, min(n0 + tile, n), cout))
            for n0 in range(0, n, tile)]
    assert 3 in taps
    x, a0, w3, bias3 = _front_case(dev, 2, 300, 2, 192, cout, tile + cout)
    _check(ops.decoder_block.tconv_phase(x, a0, w3, bias3, 2, tile=tile),
           _front_reference(x, a0, w3, bias3, 2))


@pytest.mark.parametrize("s,cin,cout", [(2, 192, 96), (4, 384, 192), (2, 32, 16)])
@pytest.mark.parametrize("t", [1, 5, 129, 130])
def test_decoder_block_front_batch_rows_do_not_bleed(dev, s, cin, cout, t):
    """B = 3 at the tile the wrapper picks, each row held against that row
    alone: a tap's frame t0 - 1 or t0 + 128 never comes from the
    neighbouring row."""
    x, a0, w3, bias3 = _front_case(dev, 3, t, s, cin, cout, t)
    out = ops.decoder_block.tconv_phase(x, a0, w3, bias3, s)
    for i in range(3):
        _check(out[i:i + 1], _front_reference(x[i:i + 1], a0, w3, bias3, s))


def test_decoder_block_front_is_deterministic(dev):
    """No atomics and no split sums: reruns give the same bits at every tile."""
    x, a0, w3, bias3 = _front_case(dev, 2, 700, 4, 384, 192, 1)
    for tile in ops.decoder_block.DECODER_BLOCK_TILES:
        first = ops.decoder_block.tconv_phase(x, a0, w3, bias3, 4, tile=tile)
        for _ in range(3):
            assert torch.equal(ops.decoder_block.tconv_phase(x, a0, w3, bias3, 4, tile=tile), first)
    with pytest.raises(ValueError):
        ops.decoder_block.tconv_phase(x, a0, w3, bias3, 4, tile=32)  # not compiled


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


@pytest.mark.parametrize("t", [150, 500])
@pytest.mark.parametrize("lens", [None, (1.0, 0.8, 0.55, 0.3)])
def test_attention_hubert_shapes_match_plain(dev, t, lens):
    """K3 at HuBERT-large's layers (H16 D64): one prompt of T frames
    unmasked at B1, and a batch of 4 ragged prompts with the key mask."""
    gen = torch.Generator(device=dev).manual_seed(t)
    b = 1 if lens is None else 4
    q, k, v = (torch.randn(b, t, 16, 64, generator=gen, device=dev).bfloat16() for _ in range(3))
    mask = None
    if lens is not None:
        n = torch.tensor([round(f * t) for f in lens], device=dev)
        mask = torch.arange(t, device=dev)[None, :] < n[:, None]
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


def _int8_case(dev, lead, k, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*lead, k, generator=gen, device=dev).bfloat16()
    w = torch.randn(k, n, generator=gen, device=dev) * (0.5 + 1.5 * torch.rand(n, generator=gen, device=dev))
    return (x, *ops.quantize_weight(w))


# the gate's edges (K = 32, 96 and K % 64 == 32 end in a half K step; M 1,
# 65 and 5528 end in a ragged row tile), N = 8192, and the served shapes
@pytest.mark.parametrize("lead,k,n", [
    ((1,), 32, 128), ((129,), 384, 384), ((662,), 1024, 4096), ((1382,), 192, 384),
    ((2648,), 1024, 4096), ((65,), 4096, 1024), ((2, 77), 384, 1536), ((3, 662), 1024, 8192),
    ((7,), 96, 128), ((65,), 160, 128), ((1,), 1056, 128), ((5528,), 384, 1536),
    ((5528,), 1536, 384), ((516,), 384, 384), ((1,), 1024, 8192),
])
def test_int8_dense_kernel_matches_plain(dev, lead, k, n):
    x, q, scale = _int8_case(dev, lead, k, n, seed=k + n)
    reset_launches()
    out = ops.int8_dense(x, q, scale)
    assert launches["int8_dense"] == 1 and out.shape == (*lead, n) and out.dtype == torch.bfloat16
    _check(out, ops.int8_dense_reference(x, q, scale))


@pytest.mark.parametrize("tile", ops.qdense.INT8_TILES)
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("m,k,n", [(131, 160, 256), (300, 1024, 512), (1, 224, 256)])
def test_int8_dense_every_tile_matches_plain(dev, tile, splits, m, k, n):
    """Each compiled tile, whole and with its K steps split over a cluster
    of 2 or 3 blocks, at a ragged last row tile (for every BM), a half last
    K step, more K steps than stages, and more than one column block."""
    x, q, scale = _int8_case(dev, (m,), k, n, seed=m + k)
    out = ops.int8_dense(x, q, scale, tile=(*tile, splits))
    _check(out, ops.int8_dense_reference(x, q, scale))


def test_int8_dense_is_deterministic(dev):
    """Each block sums its K steps in order and a split's sums are added in
    cluster-rank order, with no atomics: reruns give the same bits, at every
    tile and split."""
    x, q, scale = _int8_case(dev, (700,), 1056, 1024, seed=5)
    for tile in ops.qdense.INT8_TILES:
        for splits in (1, 2, 4):
            first = ops.int8_dense(x, q, scale, tile=(*tile, splits))
            for _ in range(3):
                assert torch.equal(ops.int8_dense(x, q, scale, tile=(*tile, splits)), first)


def test_int8_dense_rejects_a_tile_it_does_not_have(dev):
    x, q, scale = _int8_case(dev, (5,), 128, 384, seed=0)
    for tile in ((256, 128, 1), (64, 64, 1), (128, 32, 1), (128, 64)):  # not compiled
        with pytest.raises(ValueError):
            ops.int8_dense(x, q, scale, tile=tile)
    with pytest.raises(ValueError):  # more splits than the 2 K steps of K = 128
        ops.int8_dense(x, q, scale, tile=(128, 64, 3))


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
    with pytest.raises(ValueError):  # f16 activations (K5 takes bf16, and f32 in its f32 kernel)
        ops.int8_dense(xb.half(), wq, scale)
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


@pytest.mark.parametrize("block_q", [64, 128])
def test_flash_mha_forced_query_tile_matches_plain(dev, block_q):
    """``block_q`` forces K3's tile; B1 T604 H8 takes 64 by itself, B4 T600
    H16 takes 128, so each forced tile is the one the shape would not get."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, t, h = (4, 600, 16) if block_q == 64 else (1, 604, 8)
    assert ops.attention.attention_query_tile(b, h, t, sms) != block_q
    gen = torch.Generator(device=dev).manual_seed(block_q)
    q, k, v = (torch.randn(b, t, h, 24, generator=gen, device=dev).bfloat16() for _ in range(3))
    mask = torch.arange(t, device=dev)[None, :] < torch.tensor([t - 70 * i for i in range(b)],
                                                               device=dev)[:, None]
    out = ops.flash_mha(q, k, v, mask=mask, block_q=block_q)
    _check(out, ops.mha_reference(q, k, v, mask=mask))
    with pytest.raises(ValueError):  # K3 has no 32-row tile
        ops.flash_mha(q, k, v, mask=mask, block_q=32)


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
    """K5 has no backward (nor has the JAX package's int8_dense): it raises
    when autograd would need one. K1 and K2 have one (the plain version's
    VJP): under autograd their outputs join the graph."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, 40, 32, generator=gen, device=dev).bfloat16().requires_grad_()
    p = _resunit_params(32, dev, gen)
    w3 = phase_weights(torch.randn(4, 32, 16, generator=gen, device=dev).bfloat16(), 2).contiguous()
    rus = [_resunit_params(16, dev, gen) for _ in range(3)]
    args = (_alpha(32, dev, gen), w3, _bias(16, dev, gen).repeat(2), rus, 2)
    assert ops.fused_residual_unit(x, *p, 1).grad_fn is not None
    assert ops.fused_decoder_block(x, *args).grad_fn is not None
    wq, scale = ops.quantize_weight(torch.randn(32, 128, generator=gen, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.int8_dense(x, wq, scale)
    with torch.no_grad():  # under no_grad they run, detached
        assert not ops.fused_residual_unit(x, *p, 1).requires_grad
        assert not ops.fused_decoder_block(x, *args).requires_grad
        assert not ops.int8_dense(x, wq, scale).requires_grad


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


@pytest.mark.parametrize("b,t,c,dil", [(2, 37, 16, 1), (1, 700, 384, 9), (1, 4002, 384, 3)])
def test_resunit_gradient_is_the_plain_versions(dev, b, t, c, dil):
    """K1 under autograd: one launch forward, and the gradient of x, both
    alphas, both weights and both biases is the plain version's (the
    backward is its VJP on the same inputs)."""
    gen = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(b, t, c, generator=gen, device=dev).bfloat16()
    p = _resunit_params(c, dev, gen)
    g = torch.randn(b, t, c, generator=gen, device=dev)
    kernel, plain = _leaves(x, *p), _leaves(x, *p)
    reset_launches()
    out = ops.fused_residual_unit(*kernel, dil)
    (out.float() * g).sum().backward()
    assert launches["resunit"] == 1
    (ops.resunit_reference(*plain, dilation=dil).float() * g).sum().backward()
    for a, r in zip(kernel, plain):
        assert a.grad is not None and a.grad.dtype == a.dtype
        _check(a.grad, r.grad)


@pytest.mark.parametrize("b,t,s,cin,cout", [(2, 21, 2, 32, 16), (1, 100, 4, 384, 192)])
def test_decoder_block_gradient_is_the_plain_versions(dev, b, t, s, cin, cout):
    """K2 (+ its three K1 units) under autograd: one K2 and three K1
    launches forward; the gradient of x, the front's alpha, phase weights
    and bias, and the 18 unit tensors is the plain version's."""
    gen = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(b, t, cin, generator=gen, device=dev).bfloat16()
    wt = (torch.rand(2 * s, cin, cout, generator=gen, device=dev) * 2 - 1) * (2 * s * cout) ** -0.5
    front = (_alpha(cin, dev, gen), phase_weights(wt.bfloat16(), s).contiguous(),
             _bias(cout, dev, gen).repeat(s))
    flat = [q for _ in range(3) for q in _resunit_params(cout, dev, gen)]
    g = torch.randn(b, t * s, cout, generator=gen, device=dev)

    def units(ps):
        return [tuple(ps[i:i + 6]) for i in range(0, 18, 6)]

    kernel, plain = _leaves(x, *front, *flat), _leaves(x, *front, *flat)
    reset_launches()
    out = ops.fused_decoder_block(*kernel[:4], units(kernel[4:]), s)
    (out.float() * g).sum().backward()
    assert launches["decoder_block"] == 1 and launches["resunit"] == 3
    (ops.decoder_block_reference(*plain[:4], units(plain[4:]), stride=s).float()
     * g).sum().backward()
    for a, r in zip(kernel, plain):
        assert a.grad is not None
        _check(a.grad, r.grad)


def test_codec_gradient_through_k1_and_k2_matches_the_plain_versions(dev, monkeypatch):
    """A bf16 codec (every unit and the three even-stride blocks on the
    kernels) under autograd: the gradients of the input, v, g, the alphas
    and the biases through K1 and K2 against the same model with the plain
    versions swapped in (the flattened gradient within 0.02, chip_smoke.py's
    CODEC_GRAD_REL_L2_TOL) and, tensor by tensor, against the f32 model's:
    no farther than twice the plain bf16 composition's distance plus 2e-3
    (CODEC_GRAD_NOISE_FACTOR, _FLOOR; bf16 rounding alone puts a tensor's
    gradient ~2-3 % from the f32 one). The tensors are the kernels' (as in
    chip_smoke.py): a scalar such as the last conv's g sums thousands of
    random-signed terms, and moves by ~20 % with 0.5 % of activation noise."""
    import copy

    import edm_tts_tpu_torch.models.codec.decoder as decoder_mod
    import edm_tts_tpu_torch.models.codec.layers as layers_mod
    from edm_tts_tpu_torch.convert import init_random_weights
    from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
    from edm_tts_tpu_torch.models.codec.decoder import DecoderBlock
    from edm_tts_tpu_torch.models.codec.layers import ResidualUnit

    codec = Codec(CodecConfig(encoder_dim=16, decoder_dim=256, n_codebooks=2, codebook_size=16,
                              codebook_dim=4), device=dev, dtype=torch.bfloat16)
    init_random_weights(codec, 0)
    c32 = copy.deepcopy(codec)
    c32.encoder.float()
    c32.decoder.float()
    c32.dtype = torch.float32
    c32.pack()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 3200, 1, generator=gen, device=dev) * 0.3
    z = torch.randn(2, 10, codec.config.latent_dim, generator=gen, device=dev)
    w_z = torch.randn(2, 10, codec.config.latent_dim, generator=gen, device=dev)
    w_a = torch.randn(2, 3200, 1, generator=gen, device=dev)

    def gradients(model):
        """The input's gradient and those of the kernel-run tensors: every
        residual unit's, the K2 blocks' snake and transposed conv."""
        model.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_()
        loss = ((model.encoder(xg).float() * w_z).sum()
                + (model.decode(z, 3200).float() * w_a).sum())
        loss.backward()
        return {"x": xg.grad.float(), **{
            f"{name}.{p_name}": p.grad.float().clone() for name, m in model.named_modules()
            if isinstance(m, ResidualUnit) or (isinstance(m, DecoderBlock) and m.fused)
            for p_name, p in (m.named_parameters() if isinstance(m, ResidualUnit)
                              else m.block[:2].named_parameters())}}

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def flat(g):
        return torch.cat([v.flatten() for v in g.values()])

    reset_launches()
    with_kernels = gradients(codec)
    fused = sum(1 for b in codec.decoder.model[1:5] if b.fused)  # the s8, s4 and s2 blocks
    assert fused == 3 and launches["resunit"] == 24 and launches["decoder_block"] == fused
    exact = gradients(c32)
    monkeypatch.setattr(layers_mod, "fused_residual_unit",
                        lambda x, *p: ops.resunit_reference(x, *p[:-1], dilation=p[-1]))
    monkeypatch.setattr(decoder_mod, "fused_decoder_block",
                        lambda x, a0, w3, b3, ru, s: ops.decoder_block_reference(
                            x, a0, w3, b3, ru, stride=s))
    reset_launches()
    plain = gradients(codec)
    assert all(v == 0 for v in launches.values())
    assert with_kernels.keys() == plain.keys() == exact.keys()
    assert any(k.endswith("weight_g") for k in plain)
    assert rel(flat(with_kernels), flat(plain)) <= 0.02
    for name, ref in exact.items():
        assert rel(with_kernels[name], ref) <= 2.0 * rel(plain[name], ref) + 2e-3, name


@pytest.mark.parametrize("b,t,h,d", [(2, 37, 3, 24), (1, 130, 2, 64), (2, 701, 8, 24), (1, 5, 1, 40),
                                     (2, 100, 2, 8), (1, 77, 3, 20)])
@pytest.mark.parametrize("variant", ops.attn_variants.VARIANTS)
@pytest.mark.parametrize("block_q", ops.attn_variants.BLOCK_Q)
def test_attn_variant_kernel_matches_plain(dev, b, t, h, d, variant, block_q):
    gen = torch.Generator(device=dev).manual_seed(t + d)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16() for _ in range(3))
    reset_launches()
    out = ops.attn_variant(q, k, v, variant=variant, block_q=block_q)
    assert launches["attn_variants"] == 1
    _check(out, ops.attn_variant_reference(q, k, v, variant=variant))


def test_attn_variant_is_deterministic(dev):
    """Each warp sums its key tiles in order: reruns give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 333, 4, 20, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    for variant in ops.attn_variants.VARIANTS:
        for block_q in ops.attn_variants.BLOCK_Q:
            first = ops.attn_variant(q, k, v, variant=variant, block_q=block_q)
            for _ in range(2):
                assert torch.equal(ops.attn_variant(q, k, v, variant=variant, block_q=block_q),
                                   first)


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
