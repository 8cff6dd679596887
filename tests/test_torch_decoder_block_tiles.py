"""K2's front as its blocks compute it, on the CPU.

The kernel (edm_tts_tpu_torch/csrc/decoder_block.cu, conv_gemm.cuh) skips,
per block of output columns, the taps of the phase weights that are zero
for all its columns, and picks its column tile with a cost model. Here,
without the card: the zero blocks of ``phase_weights`` lie exactly where
``phase_taps`` says; a plain model of the blocks (``_tiled_front``)
equals ``tconv_phase_reference`` exactly on integer data (every product
and sum exact in f32, so a skipped nonzero tap would show) and the JAX
package's ``_block_ref`` front within the tolerance of
tests/test_torch_kernels_ref.py (atol/rtol 1e-4: same math, other
summation order); and ``decoder_block_tile`` picks, at the decoder's
shapes, a tile the source compiles.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edm_tts_tpu.ops.pallas_decoder_block import _block_ref
from edm_tts_tpu_torch.kernels import H100_SMS, launches, reset_launches
from edm_tts_tpu_torch.ops import decoder_block as block_ops
from edm_tts_tpu_torch.profile_decoder_block import CASES

TOL = dict(atol=1e-4, rtol=1e-4)
SOURCE = Path(block_ops.__file__).resolve().parent.parent / "csrc" / "decoder_block.cu"


@pytest.mark.parametrize("s", [2, 4, 8])
def test_phase_weight_zeros_lie_where_the_tap_skip_assumes(s):
    """With a kernel of no zero entry, w3[m][:, n] is all zero exactly when
    tap m is not among phase_taps of column n: w3[2] below half = (s/2)
    C_out, w3[0] from there on, w3[1] nowhere."""
    cin, cout = 5, 3
    kernel = torch.from_numpy(np.random.default_rng(s).uniform(1.0, 2.0, (2 * s, cin, cout)))
    w3 = block_ops.phase_weights(kernel, s)
    half = s // 2 * cout
    for n in range(s * cout):
        taps = block_ops.phase_taps(n, n + 1, half)
        assert len(taps) == 2
        for m in range(3):
            assert bool((w3[m, :, n] == 0).all()) == (m not in taps), (n, m)


def test_phase_taps_of_a_column_range():
    assert list(block_ops.phase_taps(0, 96, 96)) == [0, 1]
    assert list(block_ops.phase_taps(96, 192, 96)) == [1, 2]
    assert list(block_ops.phase_taps(64, 128, 96)) == [0, 1, 2]
    assert list(block_ops.phase_taps(0, 192, 96)) == [0, 1, 2]


def _tiled_front(x, alpha0, w3, bias3, *, stride, tile):
    """The phase product as K2's blocks compute it: column tiles of ``tile``
    columns, each over ``phase_taps`` only (the zero taps skipped)."""
    t, n = x.shape[1], w3.shape[-1]
    y = F.pad(block_ops.snake(x, alpha0), (0, 0, 1, 1))
    cols = []
    for n0 in range(0, n, tile):
        n1 = min(n0 + tile, n)
        taps = block_ops.phase_taps(n0, n1, stride // 2 * (n // stride))
        cols.append(sum(y[:, m:m + t] @ w3[m, :, n0:n1] for m in taps) + bias3[n0:n1])
    return torch.cat(cols, dim=-1)


def _integer_front(rng, b, t, s, cin, cout):
    """Integer x, kernel and bias, and alphas so small that snake(x) == x in
    f32: every product and sum of the phase product is exact."""
    x = torch.from_numpy(rng.integers(-3, 4, (b, t, cin)).astype(np.float32))
    kernel = torch.from_numpy(rng.integers(-3, 4, (2 * s, cin, cout)).astype(np.float32))
    bias = torch.from_numpy(rng.integers(-3, 4, cout).astype(np.float32))
    alpha0 = torch.full((cin,), 1e-20)
    assert torch.equal(block_ops.snake(x, alpha0), x)
    return x, alpha0, block_ops.phase_weights(kernel, s), bias.repeat(s)


@pytest.mark.parametrize("tile", block_ops.DECODER_BLOCK_TILES)
@pytest.mark.parametrize("s,cout", [(2, 96), (4, 48), (8, 16), (2, 16)])
def test_tiled_front_equals_the_reference_exactly(tile, s, cout):
    """The blocks' taps (two per half, three across it) lose no nonzero
    term: on exact data the tiled composition equals the one-product
    reference to the bit, at every tile, with frames 1 and 130."""
    rng = np.random.default_rng(tile + s + cout)
    for t in (1, 130):
        x, alpha0, w3, bias3 = _integer_front(rng, 2, t, s, 40, cout)
        ref = block_ops.tconv_phase_reference(x, alpha0, w3, bias3)
        out = _tiled_front(x, alpha0, w3, bias3, stride=s, tile=tile)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("s,cin,cout,t", [(2, 24, 16, 61), (4, 16, 32, 40), (8, 8, 8, 9)])
@pytest.mark.parametrize("tile", [64, 96])
def test_tiled_front_matches_the_jax_front(s, cin, cout, t, tile):
    """Against the JAX package's plain composition cut after its transposed
    conv (``_block_ref`` with no residual units), f32."""
    rng = np.random.default_rng(s * t)
    x = (rng.standard_normal((2, t, cin)) * 0.5).astype(np.float32)
    alpha0 = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    wt = (rng.standard_normal((2 * s, cin, cout)) * 0.2).astype(np.float32)
    bt = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    w3 = block_ops.phase_weights(torch.from_numpy(wt), s)
    out = _tiled_front(torch.from_numpy(x), torch.from_numpy(alpha0), w3,
                                      torch.from_numpy(bt).repeat(s), stride=s, tile=tile)
    jax_front = _block_ref(jnp.asarray(x), jnp.asarray(alpha0), jnp.asarray(wt),
                           jnp.asarray(bt), (), stride=s)
    np.testing.assert_allclose(out.reshape(2, t * s, cout).numpy(), np.asarray(jax_front), **TOL)


def test_the_cpu_front_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(0)
    x, alpha0, w3, bias3 = _integer_front(rng, 2, 7, 4, 16, 16)
    reset_launches()
    out = block_ops.tconv_phase(x, alpha0, w3, bias3, 4, tile=96)
    ref = block_ops.tconv_phase_reference(x, alpha0, w3, bias3)
    assert torch.equal(out, ref.reshape(2, 28, 16))
    assert launches["decoder_block"] == 0


def _compiled_tiles() -> set[int]:
    entry = SOURCE.read_text().split('extern "C" int edm_tconv_phase')[1]
    return {int(n) for n in re.findall(r"case (\d+): return \(int\)launch_tconv<\1>", entry)}


def test_every_tile_the_model_can_pick_is_compiled():
    assert _compiled_tiles() == set(block_ops.DECODER_BLOCK_TILES)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("batch", [1, 4])
def test_tile_choice_at_the_decoder_shapes(sms, batch):
    """At run (a)'s two blocks (and a batch of 4 of them), on an H100 SXM's
    132 SMs and a PCIe card's 114: a compiled tile; at s 4 (halves of 384
    columns) one whose blocks all lie in one half, so none runs three taps;
    the choice is cached per shape."""
    if sms == H100_SMS and batch == 1:
        # the fastest of every tile in profile_decoder_block's sweep on an
        # H100 SXM (PERF.md): s4 128 (0.0730 ms; 64-256: 0.0746-0.0860), s2
        # 96 (0.0744 ms; the others 0.0785-0.0839)
        assert [block_ops.decoder_block_tile(1, t, cin, s * cout, s)
                for _, _, t, cin, cout, s in CASES] == [128, 96]
    for _, _, t, cin, cout, s in CASES:
        n = s * cout
        tile = block_ops.decoder_block_tile(batch, t, cin, n, s, sms)
        assert tile in _compiled_tiles()
        if s == 4:
            assert all(len(block_ops.phase_taps(n0, min(n0 + tile, n), n // 2)) == 2
                       for n0 in range(0, n, tile))
        assert block_ops.decoder_block_tile(batch, t, cin, n, s, sms) is tile
