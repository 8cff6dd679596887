"""K5's tile choice and K3's query-tile override, on the CPU.

``int8_dense_tile`` picks K5's tile per launch from the shape and the
card's multiprocessor count; these tests hold it over the served shapes and
the shape gate's edges (the kernel itself runs only on the card:
tests/test_torch_kernels_gpu.py). ``flash_mha``'s ``block_q`` forces K3's
query tile on the card; on the CPU both wrappers compute the same function
at any tile, as the JAX package's interpret path does, so their outputs
there equal the JAX package's (the products at atol 1e-5, as
tests/test_torch_qdense.py holds them; attention at 2e-6, f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.ops.pallas_attention import flash_mha as j_flash_mha
from edm_tts_tpu.ops.qdense import int8_dense as j_int8_dense
from edm_tts_tpu_torch.ops import flash_mha, int8_dense, quantizable_shape, quantize_weight
from edm_tts_tpu_torch.ops.attention import QUERY_TILES, attention_query_tile
from edm_tts_tpu_torch.ops.qdense import INT8_TILES, MAX_SPLITS, int8_dense_tile
from edm_tts_tpu_torch.profile_qdense import CASES, SERVED_CASES

# (M, K, N) -> K5's launch on an H100 at the served shapes, as
# int8_dense_tile's cost model (fitted to profile_qdense's sweep) gives it
EXPECTED_TILES = {
    (5528, 384, 1536): (128, 256, 1), (5528, 1536, 384): (128, 128, 1),
    (5528, 384, 384): (128, 128, 1), (5528, 192, 384): (128, 128, 1),
    (5528, 768, 384): (128, 128, 1), (5528, 384, 1024): (128, 256, 1),
    (516, 384, 1536): (128, 64, 1), (516, 1536, 384): (128, 64, 2),
    (516, 384, 384): (128, 64, 1), (516, 192, 384): (128, 64, 1),
    (516, 768, 384): (128, 64, 1), (2648, 1024, 1024): (128, 256, 1),
    (2648, 1024, 2048): (128, 256, 1), (2648, 4096, 1024): (128, 256, 1),
    (2648, 2048, 1024): (128, 256, 1), (2048, 1024, 8192): (128, 256, 1),
    (512, 1024, 8192): (128, 256, 1),
}


def _all_cases():
    return [(m, k, n) for _, m, k, n in CASES + SERVED_CASES]


def _valid(launch, k, n):
    bn, bm, splits = launch
    return (bn, bm) in INT8_TILES and n % bn == 0 and 1 <= splits <= min(MAX_SPLITS, -(-k // 64))


@pytest.mark.parametrize("m,k,n", _all_cases())
def test_int8_tile_fits_every_case(m, k, n):
    assert quantizable_shape(k, n)
    assert _valid(int8_dense_tile(m, k, n), k, n)


@pytest.mark.parametrize("m", [1, 65, 516, 70000])
@pytest.mark.parametrize("k,n", [(32, 128), (96, 384), (4096, 8192)])
@pytest.mark.parametrize("sms", [78, 132])
def test_int8_tile_at_the_gates_edges(m, k, n, sms):
    """Any M >= 1, K % 32 == 0 and N % 128 == 0 (the gate's edges: K = 32
    and 96 have one and two K steps to split), on cards of other sizes: a
    compiled tile whose columns divide N and no more splits than K steps."""
    assert _valid(int8_dense_tile(m, k, n, sms), k, n)


def test_int8_tile_of_the_served_shapes():
    """The served batch's shapes get the launches measured on the H100."""
    for _, m, k, n in SERVED_CASES:
        assert int8_dense_tile(m, k, n) == EXPECTED_TILES[(m, k, n)], (m, k, n)


@pytest.mark.parametrize("tile", [None, *((*t, 2) for t in INT8_TILES)])
def test_int8_dense_on_the_cpu_ignores_the_tile(tile):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 96)).astype(np.float32)
    q, scale = quantize_weight(torch.from_numpy(rng.standard_normal((96, 256)).astype(np.float32)))
    out = int8_dense(torch.from_numpy(x), q, scale, tile=tile)
    ref = j_int8_dense(jnp.asarray(x), jnp.asarray(q.numpy()), jnp.asarray(scale.numpy()),
                       implementation="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_query_tile_override_is_checked():
    assert attention_query_tile(1, 8, 604) == 64 and attention_query_tile(4, 16, 600) == 128
    for block_q in QUERY_TILES:
        assert attention_query_tile(1, 8, 604, block_q=block_q) == block_q
        assert attention_query_tile(4, 16, 600, block_q=block_q) == block_q
    for bad in (0, 16, 32, 96, 256):
        with pytest.raises(ValueError, match="block_q"):
            attention_query_tile(1, 8, 604, block_q=bad)


@pytest.mark.parametrize("block_q", [None, 64, 128, 32])
def test_flash_mha_on_the_cpu_ignores_block_q(block_q):
    """The JAX interpret path and the port's CPU path compute the same
    function at any query tile."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 70, 3, 24)).astype(np.float32) for _ in range(3))
    mask = np.arange(70)[None, :] < np.array([70, 41])[:, None]
    out = flash_mha(*(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(mask),
                    block_q=block_q)
    ref = j_flash_mha(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask),
                      block_q=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)
