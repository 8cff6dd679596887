"""The port's codec against edm_tts_tpu's, on weights carried across by
``to_torch_state_dict`` -> ``load_reference_state_dict``.

A tiny codec with the real strides (8, 5, 4, 2) and a narrow decoder, in
f32 on the CPU. Tolerance atol/rtol 1e-4: same math, other summation
order, through ~15 convolutions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.codec import Codec as JCodec
from edm_tts_tpu.models.codec.convert import to_torch_state_dict as codec_to_torch
from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.ops.decoder_block import phase_weights
from torch_port_parity import TINY_CODEC, as_torch, codec_pair

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def codecs():
    return codec_pair(seed=0)


def test_decode_from_codes_matches_jax(codecs):
    jmodel, variables, model = codecs
    codes = np.random.default_rng(0).integers(0, 16, (2, 4, 7))
    ref = jmodel.apply(variables, jnp.asarray(codes), method=JCodec.decode_from_codes)
    out = model.decode_from_codes(torch.from_numpy(codes))
    # 7 frames -> 8*7 -> 5*56+2 -> 4*282 -> 2*1128 samples
    assert out.shape == ref.shape == (2, model.decoded_length(7), 1) == (2, 2256, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_masked_decode_matches_jax_and_exact_size_decodes(codecs):
    """``valid_frames``: the padded-canvas decode equals JAX's masked decode,
    and each row's valid samples equal the decode of its exact-size canvas
    (the property tests/test_bucketed_inference.py pins for JAX)."""
    jmodel, variables, model = codecs
    codes = np.random.default_rng(1).integers(0, 16, (3, 4, 12))
    valid = np.array([7, 12, 3])
    ref = jmodel.apply(variables, jnp.asarray(codes), jnp.asarray(valid),
                       method=JCodec.decode_from_codes)
    with torch.no_grad():
        out = model.decode_from_codes(torch.from_numpy(codes), torch.from_numpy(valid)).numpy()
        hop = model.config.hop_length
        for i, v in enumerate(valid):
            exact = model.decode_from_codes(torch.from_numpy(codes[i:i + 1, :, :v])).numpy()
            np.testing.assert_allclose(out[i, : v * hop], exact[0, : v * hop], atol=1e-6, rtol=1e-6)
    n = model.decoded_length(12)
    assert out.shape == ref.shape == (3, n, 1)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("levels", [1, 3])
def test_codes_to_features_match_jax(codecs, levels):
    jmodel, variables, model = codecs
    codes = np.random.default_rng(levels).integers(0, 16, (2, levels, 5))
    for method, port in ((JCodec.codes_to_features, model.codes_to_features),
                         (JCodec.codes_to_features_unreduced, model.codes_to_features_unreduced)):
        ref = jmodel.apply(variables, jnp.asarray(codes), method=method)
        np.testing.assert_allclose(port(torch.from_numpy(codes)).detach().numpy(), np.asarray(ref),
                                   **TOL)


def test_decoder_lays_out_kernel_weights_at_load(codecs):
    """Loading packs the decoder's weights once as K1 and K2 take them; an
    unpacked decoder refuses to run rather than lay them out per call."""
    _, _, model = codecs
    block = model.decoder.model[3]  # stride 4: the K2 block
    assert block.fused and not model.decoder.model[2].fused  # stride 5
    alpha0, w3, bias3 = block.kernel_args
    snake0, tconv, *units = block.block
    wt, bt = tconv.folded()
    torch.testing.assert_close(alpha0, snake0.alpha.view(-1), rtol=0, atol=0)
    torch.testing.assert_close(w3, phase_weights(wt, 4), rtol=0, atol=0)
    torch.testing.assert_close(bias3, bt.repeat(4), rtol=0, atol=0)
    for unit in units:
        packed = unit.kernel_args
        assert all(p.is_contiguous() for p in packed)
        for p, f in zip(packed, unit.folded()):
            torch.testing.assert_close(p, f.reshape(p.shape), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="not packed"):
        Codec(CodecConfig(**TINY_CODEC)).decode_from_codes(torch.zeros(1, 4, 3, dtype=torch.long))


def test_loader_is_strict_and_takes_both_weight_norm_spellings(codecs):
    jmodel, variables, model = codecs
    legacy = codec_to_torch(jmodel.config, variables, legacy_wn=True)
    assert any(k.endswith(".weight_g") for k in legacy)
    fresh = Codec(CodecConfig(**TINY_CODEC))
    load_reference_state_dict(fresh, legacy)
    for (name, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    incomplete = dict(legacy)
    incomplete.pop("decoder.model.0.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(fresh, incomplete)
    extra = dict(legacy, **{"decoder.extra.bias": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(fresh, extra)
    half = dict(legacy)
    half.pop("decoder.model.0.weight_g")
    with pytest.raises(KeyError, match="incomplete"):
        load_reference_state_dict(fresh, half)


def test_weights_fold_once_at_load(codecs):
    """The folded transposed-conv weight is normalised per input channel."""
    jmodel, variables, model = codecs
    p = variables["params"]["decoder"]["DecoderBlock_0"]["WNConvTranspose1d_0"]
    v, g = np.asarray(p["v"]), np.asarray(p["g"])  # (K, C_in, C_out), (C_in,)
    expect = v * (g[None, :, None] / np.sqrt((v**2).sum(axis=(0, 2), keepdims=True)))
    kernel, _ = model.decoder.model[1].block[1].folded()
    np.testing.assert_allclose(kernel.detach().numpy(), expect, atol=1e-6, rtol=1e-6)
    assert as_torch(p["b"]).shape == model.decoder.model[1].block[1].bias.shape
