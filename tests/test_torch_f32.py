"""f32 in the port: the codec's kernel dispatch (the JAX package's "auto"
rule) and the plain f32 versions of K3 and K5 against the JAX package's
Pallas kernels in interpret mode at f32.

The dispatch is observed by swapping the kernels' entry points in the codec
modules for recorders: a bf16 decode and encode call K1 on every residual
unit and K2 on the unmasked s=4 and s=2 blocks; an f32 one calls neither
(the composition runs), as does a bf16 unit wider than 768 channels. The
f32 plain versions take the Pallas kernels' place on the CPU and are the
f32 kernels' oracles on the card: output f32, within atol/rtol 1e-5 of
the interpret-mode kernels (another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.ops.pallas_attention import flash_mha as j_flash_mha
from edm_tts_tpu.ops.qdense import int8_dense as j_int8_dense
from edm_tts_tpu.ops.qdense import quantize_weight as j_quantize_weight
from edm_tts_tpu_torch import ops
from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.codec import decoder as decoder_mod
from edm_tts_tpu_torch.models.codec import layers as layers_mod
from torch_port_parity import TINY_CODEC

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def recorded(monkeypatch):
    """Counts of the codec modules' calls into K1 and K2 (the plain
    versions still compute, on the CPU)."""
    calls = {"resunit": 0, "decoder_block": 0}

    def count(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(layers_mod, "fused_residual_unit",
                        count("resunit", layers_mod.fused_residual_unit))
    monkeypatch.setattr(decoder_mod, "fused_decoder_block",
                        count("decoder_block", decoder_mod.fused_decoder_block))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_codec_takes_the_kernels_for_bf16_only(recorded, dtype):
    cfg = CodecConfig(**TINY_CODEC)
    codec = Codec(cfg, dtype=dtype)
    init_random_weights(codec, 0)
    codes = torch.from_numpy(np.random.default_rng(0).integers(0, 16, (1, 4, 5)))
    kernels = dtype == torch.bfloat16
    with torch.no_grad():
        codec.decode_from_codes(codes)
        # the tail blocks (s 4 and 2, C_out <= 192) take K2, its units
        # inside it; the other blocks' units K1
        fused = sum(1 for b in codec.decoder.model if isinstance(b, decoder_mod.DecoderBlock)
                    and b.fused)
        units = 3 * (len(cfg.decoder_rates) - fused)
        assert recorded == {"resunit": units if kernels else 0,
                            "decoder_block": fused if kernels else 0}
        codec.decode_from_codes(codes, torch.tensor([3]))  # masked: K2 off
        assert recorded["decoder_block"] == (fused if kernels else 0)
        assert recorded["resunit"] == (2 * units + 3 * fused if kernels else 0)
        recorded["resunit"] = 0
        codec.encoder(torch.zeros(1, 640, 1, dtype=dtype))
        assert recorded["resunit"] == (3 * len(cfg.encoder_rates) if kernels else 0)


def test_resunit_rule_is_the_jax_rule():
    x16, x32 = torch.zeros(1, 4, 8, dtype=torch.bfloat16), torch.zeros(1, 4, 8)
    assert layers_mod.resunit_uses_kernel(x16, 768)
    assert not layers_mod.resunit_uses_kernel(x16, 1024)
    assert not layers_mod.resunit_uses_kernel(x32, 64)
    unit = layers_mod.ResidualUnit(1024, 3, dtype=torch.bfloat16)
    init_random_weights(unit, 0)
    unit.pack()
    x = torch.randn(1, 9, 1024).bfloat16()
    with torch.no_grad():
        out = unit(x)
    want = ops.resunit_reference(x, *unit.folded(), dilation=3)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,t,h,d,lens", [
    (1, 40, 16, 64, None),          # HuBERT / s2a heads
    (2, 37, 16, 64, (37, 20)),      # HuBERT's masked batch
    (2, 45, 8, 24, (45, 9)),        # the t2s canvas
])
def test_attention_f32_plain_matches_pallas_interpret(b, t, h, d, lens):
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = None if lens is None else np.arange(t)[None] < np.array(lens)[:, None]
    j_mask = None if mask is None else jnp.asarray(mask)
    ref, ref_lse = j_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=j_mask,
                               interpret=True, return_lse=True)
    assert ref.dtype == jnp.float32
    t_mask = None if mask is None else torch.from_numpy(mask)
    out, lse = ops.flash_mha(*map(torch.from_numpy, (q, k, v)), mask=t_mask, return_lse=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0], **TOL)
    torch.testing.assert_close(
        ops.mha_reference(*map(torch.from_numpy, (q, k, v)), mask=t_mask), out, rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n", [(33, 96, 128), (70, 64, 256)])
def test_int8_dense_f32_plain_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)) * rng.uniform(0.5, 2.0, n)
    q, scale = (np.array(a) for a in j_quantize_weight(jnp.asarray(w, jnp.float32)))
    ref = j_int8_dense(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                       implementation="pallas", interpret=True)
    assert ref.dtype == jnp.float32
    out = ops.int8_dense(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
