"""The port's tensor ops against edm_tts_tpu/ops, on the same numpy inputs.

Tolerance: atol/rtol 1e-4 in f32 unless a test says otherwise (the two
frameworks sum in different orders; the ops here are a few f32 roundings
deep). Masks and tokens must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu import ops as jops
from edm_tts_tpu.ops.snake import cos_fast as j_cos_fast
from edm_tts_tpu.models.codec import CodecConfig as JCodecConfig
from edm_tts_tpu.models.s2a import S2AConfig as JS2AConfig
from edm_tts_tpu.models.t2s import SPECIAL_TOKENS as J_SPECIAL_TOKENS
from edm_tts_tpu.models.t2s import T2SConfig as JT2SConfig
from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.models.codec import CodecConfig
from edm_tts_tpu_torch.models.s2a import S2AConfig
from edm_tts_tpu_torch.models.t2s import SPECIAL_TOKENS, T2SConfig

TOL = dict(atol=1e-4, rtol=1e-4)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def test_cos_fast_and_snake_match_jax():
    rng = np.random.default_rng(0)
    u = (rng.standard_normal(4096) * 200).astype(np.float32)
    # the same polynomial on the same f32 inputs: agreement to a few ulps
    _close(ops.cos_fast(torch.from_numpy(u)), j_cos_fast(jnp.asarray(u)), atol=1e-6, rtol=0)
    x = rng.standard_normal((2, 33, 16)).astype(np.float32) * 3
    a = (rng.random(16) + 0.5).astype(np.float32)
    _close(ops.snake(torch.from_numpy(x), torch.from_numpy(a)), jops.snake(jnp.asarray(x), jnp.asarray(a)))


@pytest.mark.parametrize("dilation,groups,padding", [(1, 1, 3), (3, 1, (9, 9)), (1, 4, (2, 1))])
def test_conv1d_matches_jax(dilation, groups, padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    k = rng.standard_normal((7 if groups == 1 else 4, 8 // groups, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    port = ops.conv1d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                      padding=padding, dilation=dilation, groups=groups)
    ref = jops.conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), padding=padding,
                      dilation=dilation, groups=groups)
    assert port.shape == ref.shape
    _close(port, ref)


@pytest.mark.parametrize("stride", [2, 4, 5, 8])
def test_conv_transpose1d_matches_jax(stride):
    rng = np.random.default_rng(stride)
    t = 9
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    k = rng.standard_normal((2 * stride, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    kw = dict(stride=stride, padding=stride // 2, output_padding=stride % 2)
    port = ops.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), **kw)
    ref = jops.conv_transpose1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), **kw)
    # torch length arithmetic: an odd stride adds 2 samples
    assert port.shape == ref.shape == (2, stride * t + (2 if stride % 2 else 0), 5)
    _close(port, ref)


def test_weight_norm_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((7, 6, 5)).astype(np.float32)
    g = rng.random(5).astype(np.float32) + 0.5
    _close(ops.weight_norm(torch.from_numpy(v), torch.from_numpy(g)),
           jops.weight_norm(jnp.asarray(v), jnp.asarray(g)), atol=1e-6, rtol=1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    t = rng.standard_normal((2, 50, 3, 24)).astype(np.float32)
    port_f = ops.rope_frequencies(50, 24)
    ref_f = jops.rope_frequencies(50, 24)
    _close(port_f, ref_f, atol=1e-5, rtol=1e-6)
    _close(ops.apply_rope(port_f[:, None, :], torch.from_numpy(t)),
           jops.apply_rope(ref_f[:, None, :], jnp.asarray(t)))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_random_topk_mask_matches_jax(temperature):
    rng = np.random.default_rng(4)
    probs = rng.random((3, 40)).astype(np.float32)
    probs[:, ::5] = np.inf  # fixed positions are never re-masked
    gumbel = rng.gumbel(size=(3, 40)).astype(np.float32)
    mask_len = np.array([1.0, 7.9, 25.0], np.float32)
    port = ops.random_topk_mask(torch.from_numpy(mask_len), torch.from_numpy(probs),
                                temperature=temperature, gumbel=torch.from_numpy(gumbel))
    ref = jops.random_topk_mask(jax.random.PRNGKey(0), jnp.asarray(mask_len), jnp.asarray(probs),
                                temperature=temperature, gumbel=jnp.asarray(gumbel))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("steps", [2, 3, 8, 16])
def test_sampling_mask_ratios_match_jax(steps):
    _close(ops.sampling_mask_ratios(steps), jops.sampling_mask_ratios(steps), atol=1e-7, rtol=0)


def test_positional_draws_do_not_depend_on_canvas_length():
    short = ops.positional_gumbel(123, 2, 10)
    long = ops.positional_gumbel(123, 2, 37)
    torch.testing.assert_close(short, long[:, :10], rtol=0, atol=0)
    logits = torch.randn(2, 37, 16, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ops.positional_categorical(9, logits[:, :10]),
                               ops.positional_categorical(9, logits)[:, :10], rtol=0, atol=0)
    # a different seed draws different noise; the draws look like gumbel(0, 1)
    assert not torch.equal(short, ops.positional_gumbel(124, 2, 10))
    big = ops.positional_gumbel(5, 4, 50000)
    assert abs(big.mean().item() - 0.5772) < 0.02 and abs(big.std().item() - 1.2825) < 0.02


def test_embed_take_matches_jax():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((11, 4)).astype(np.float32)
    ids = rng.integers(0, 11, (3, 7))
    _close(ops.embed_take(torch.from_numpy(table), torch.from_numpy(ids)),
           jops.embed_take(jnp.asarray(table), jnp.asarray(ids)), atol=0, rtol=0)


def test_copied_constants_and_configs_match_jax():
    assert SPECIAL_TOKENS == J_SPECIAL_TOKENS
    assert CodecConfig().to_json() == JCodecConfig().to_json()
    assert T2SConfig().to_json() == JT2SConfig().to_json()
    assert S2AConfig().to_json() == JS2AConfig().to_json()
    t2s = T2SConfig(hidden_size=384, main_encoder_num_heads=8, main_encoder_dim_head=24)
    jt2s = JT2SConfig(hidden_size=384, main_encoder_num_heads=8, main_encoder_dim_head=24)
    for port_cfg, jax_cfg in ((t2s.main_encoder_config, jt2s.main_encoder_config),
                              (S2AConfig().encoder_config, JS2AConfig().encoder_config)):
        for f in dataclasses.fields(port_cfg):
            assert getattr(port_cfg, f.name) == getattr(jax_cfg, f.name), f.name
    assert t2s.semantic_offset == jt2s.semantic_offset == 261
