"""What K1's and K6's wrappers decide on the host, held on the CPU.

K1 (edm_tts_tpu_torch/csrc/resunit.cu) runs the codec residual unit as two
products in blocks of 128 time rows x an N tile of output channels that
``ops.resunit.resunit_tile`` picks from the launch's B, T and C; the
kernel reads the weights in the layout ``ResidualUnit.pack`` gives them,
which is the JAX package's ``[tap, in, out]``. K6 (attn_variants.cu)
copies its tiles with the tensor-memory accelerator, so its wrapper
zero-pads a head depth that is not a multiple of 8 and scales by the true
depth. Here the tile choice is held at the port's shapes, the packed
weights through the plain path (what the CPU runs) against the JAX
package's reference unit, and the padded plain attention variants against
the unpadded ones.

Tolerances: the packed unit against the JAX composition in f32, atol/rtol
1e-4, as tests/test_torch_kernels_ref.py holds the plain unit; padded
against unpadded plain variants, atol/rtol 1e-6 (zero lanes add exact
zeros to f32 sums; only the order of the sums may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edm_tts_tpu.ops.pallas_resunit import _resunit_ref
from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.kernels import H100_SMS, launches, reset_launches
from edm_tts_tpu_torch.models.codec.layers import ResidualUnit
from edm_tts_tpu_torch.ops.attn_variants import VARIANTS, attn_variant, attn_variant_reference
from edm_tts_tpu_torch.ops.resunit import RESUNIT_TILES, resunit_tile
from edm_tts_tpu_torch.profile_resunit import CASES, ONE_ROW_CASES, SERVED_CASES

EXACT = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,t,c,want", [
    (1, 4000, 768, 192),     # one request's block 0: 32 row tiles x 4 = 128 blocks, one wave
    (1, 20002, 384, 128),    # block 1
    (1, 80008, 192, 192),    # block 2: one tile covers C
    (1, 160016, 96, 128),    # block 3: one 128-column tile, 96 of them used
    (4, 4096, 768, 256),     # the served batch's block 0: 128 x 3 = 384 blocks, 3 waves
    (4, 20482, 384, 128),
    (4, 81928, 192, 192),
    (4, 163856, 96, 128),
    (2, 37, 16, 64),         # narrow channels: the narrowest tile
    (1, 5, 768, 64),         # one short row tile: 12 blocks of the cheapest steps
])
def test_resunit_tile_at_the_ports_shapes(b, t, c, want):
    assert resunit_tile(b, t, c) == want


@pytest.mark.parametrize("label,b,t,c,dil", CASES + SERVED_CASES + ONE_ROW_CASES)
def test_resunit_tile_is_compiled_and_depends_on_the_shape_only(label, b, t, c, dil):
    tile = resunit_tile(b, t, c)
    assert tile in RESUNIT_TILES
    assert resunit_tile(b, t, c, sms=H100_SMS) == tile


def test_resunit_tile_follows_the_cards_size():
    """Fewer SMs leave fewer slots per wave: at 4000 x 768 the 192-column
    tile's 128 blocks fill a 132-SM card in one wave, a 100-SM card in two,
    where the 256-column tile's 96 blocks still take one."""
    assert resunit_tile(1, 4000, 768, sms=132) == 192
    assert resunit_tile(1, 4000, 768, sms=100) == 256


def test_cases_are_the_decoders_residual_units():
    """profile_resunit's cases: 3 dilations per decoder block, T upsampled by
    the strides (8, 5, 4, 2; the odd stride adds 2), C halving from 768."""
    assert [(t, c) for _, _, t, c, d in CASES if d == 1] == [
        (4000, 768), (20002, 384), (80008, 192), (160016, 96)]
    assert [(b, t, c) for _, b, t, c, d in SERVED_CASES if d == 9] == [
        (4, 4096, 768), (4, 20482, 384), (4, 81928, 192), (4, 163856, 96)]
    assert {b for _, b, *_ in ONE_ROW_CASES} == {1}
    assert [d for *_, d in CASES[:3]] == [1, 3, 9]


def _seeded_unit(c, dilation, rng):
    unit = ResidualUnit(c, dilation)
    with torch.no_grad():
        for p in unit.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.1))
        for snake in (unit.block[0], unit.block[2]):
            snake.alpha.add_(1.0)
    unit.pack()
    return unit


@pytest.mark.parametrize("c,dilation,t", [(16, 1, 40), (32, 3, 150), (64, 9, 70)])
def test_packed_unit_through_the_plain_path_matches_jax(c, dilation, t):
    """The weights as ``pack`` lays them out for K1, read back through the
    plain path the wrapper takes on the CPU, give the plain unit on
    ``folded()`` and the JAX package's reference unit; no launch is counted."""
    rng = np.random.default_rng(c + dilation)
    unit = _seeded_unit(c, dilation, rng)
    x = torch.from_numpy(rng.standard_normal((2, t, c)).astype(np.float32))
    reset_launches()
    with torch.no_grad():
        port = unit(x)
        forced = ops.fused_residual_unit(x, *unit.kernel_args, dilation, tile=256)
    assert launches["resunit"] == 0
    torch.testing.assert_close(port, ops.resunit_reference(x, *unit.folded(), dilation=dilation),
                               rtol=0, atol=0)
    torch.testing.assert_close(forced, port, rtol=0, atol=0)  # the CPU ignores the tile
    a1, w7, b7, a2, w1, b1 = (jnp.asarray(p.detach().numpy()) for p in unit.kernel_args)
    ref = _resunit_ref(jnp.asarray(x.numpy()), a1, w7, b7, a2, w1, b1, dilation=dilation)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [5, 20, 24, 40])
def test_attn_variant_depth_padding_keeps_the_plain_version(variant, d):
    """Zero lanes up to the next multiple of 8 with the true depth's scale,
    as K6's wrapper pads: the kept lanes equal the unpadded plain variant."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, 3, d)).astype(np.float32))
               for _ in range(3))
    dp = ops.attention.padded_depth(d)
    assert dp % 8 == 0 and 0 <= dp - d < 8
    padded = attn_variant_reference(*(F.pad(z, (0, dp - d)) for z in (q, k, v)),
                                    variant=variant, scale=d ** -0.5)
    assert padded.shape == (2, 70, 3, dp) and not padded[..., d:].any()
    torch.testing.assert_close(padded[..., :d], attn_variant_reference(q, k, v, variant=variant),
                               **EXACT)
    reset_launches()
    torch.testing.assert_close(attn_variant(q, k, v, variant=variant),
                               attn_variant_reference(q, k, v, variant=variant), rtol=0, atol=0)
    assert launches["attn_variants"] == 0
