"""The port's HuBERT against edm_tts_tpu's and against HF ``transformers``,
and its weight bridge in both directions.

Tiny configs (``HUBERT_TINY_TEST``; a 24-layer narrow one for layer 18), f32
on the CPU, weights from an HF ``HubertModel`` built from config
(``torch.manual_seed``) or from the JAX package's parameters. Hidden states:
atol 2e-4, rtol 1e-3, as tests/test_hubert.py holds the JAX HuBERT to HF
(same math, other summation order); at layer 18 of 24 atol 1e-3, rtol 1e-2
(f32 drift compounds with depth, as there). The copied config and
``normalize_input`` are pinned equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.hubert import HUBERT_LARGE_LL60K as J_LARGE
from edm_tts_tpu.models.hubert import HUBERT_TINY_TEST as J_TINY
from edm_tts_tpu.models.hubert import HubertModel as JHubertModel
from edm_tts_tpu.models.hubert import from_hf_state_dict
from edm_tts_tpu.models.hubert import normalize_input as j_normalize_input
from edm_tts_tpu.models.hubert.config import HubertConfig as JHubertConfig
from edm_tts_tpu_torch.convert import fold_weight_norm
from edm_tts_tpu_torch.models.hubert import (
    HUBERT_LARGE_LL60K,
    HUBERT_TINY_TEST,
    HubertConfig,
    HubertModel,
    hf_state_dict_from_jax_params,
    load_hf_state_dict,
    normalize_input,
)
from edm_tts_tpu_torch.models.hubert.convert import POS_CONV, fold_pos_conv

TOL = dict(atol=2e-4, rtol=1e-3)
DEEP = dict(conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=64,
            num_hidden_layers=24, num_attention_heads=4, intermediate_size=128,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _hf_model(cfg: HubertConfig, seed: int):
    from transformers import HubertConfig as HFConfig
    from transformers import HubertModel as HFModel

    hf_cfg = HFConfig(
        vocab_size=32, hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, intermediate_size=cfg.intermediate_size,
        conv_dim=cfg.conv_dim, conv_kernel=cfg.conv_kernel, conv_stride=cfg.conv_stride,
        conv_bias=cfg.conv_bias, num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        feat_extract_norm="layer", do_stable_layer_norm=True, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(seed)
    return HFModel(hf_cfg).eval()


@pytest.fixture(scope="module")
def tiny():
    """(HF model, JAX model, its params, port model) with HF's weights."""
    hf = _hf_model(HUBERT_TINY_TEST, 0)
    port = HubertModel(HUBERT_TINY_TEST)
    load_hf_state_dict(port, hf.state_dict())
    return hf, JHubertModel(J_TINY), from_hf_state_dict(J_TINY, hf.state_dict()), port


def test_config_copy_equals_jax():
    for mine, theirs in ((HUBERT_LARGE_LL60K, J_LARGE), (HUBERT_TINY_TEST, J_TINY)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.downsample_factor == theirs.downsample_factor
        lengths = np.arange(400, 4000, 37)
        np.testing.assert_array_equal(mine.feature_lengths(lengths), theirs.feature_lengths(lengths))
        assert int(mine.feature_lengths(torch.tensor(160160))) == theirs.feature_lengths(160160)


@pytest.mark.parametrize("output_layer", [1, None])
@pytest.mark.parametrize("masked", [False, True])
def test_hidden_states_match_jax_and_hf(tiny, output_layer, masked):
    """At ``output_layer`` 1 (HF's ``hidden_states[1]``, no final LayerNorm)
    and through the whole stack, without and with a ragged attention mask
    (only each row's valid frames compared)."""
    hf, jmodel, params, port = tiny
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((2, 500)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 500), np.int64)
        mask[1, 350:] = 0
        audio[1, 350:] = 0.0
    with torch.no_grad():
        hf_out = hf(torch.from_numpy(audio), attention_mask=None if mask is None else
                    torch.from_numpy(mask), output_hidden_states=True)
        out = port(torch.from_numpy(audio), None if mask is None else torch.from_numpy(mask),
                   output_layer=output_layer).numpy()
    theirs = (hf_out.last_hidden_state if output_layer is None
              else hf_out.hidden_states[output_layer]).numpy()
    ref = np.asarray(jmodel.apply(params, jnp.asarray(audio),
                                  None if mask is None else jnp.asarray(mask),
                                  output_layer=output_layer))
    valid = [out.shape[1], HUBERT_TINY_TEST.feature_lengths(350) if masked else out.shape[1]]
    assert out.shape == ref.shape == theirs.shape
    for i, n in enumerate(valid):
        np.testing.assert_allclose(out[i, :n], ref[i, :n], **TOL)
        np.testing.assert_allclose(out[i, :n], theirs[i, :n], **TOL)


def test_layer18_of_24_matches_jax_and_hf():
    cfg = HubertConfig(**DEEP)
    hf = _hf_model(cfg, 18)
    port = HubertModel(cfg)
    load_hf_state_dict(port, hf.state_dict())
    jcfg = JHubertConfig(**DEEP)
    audio = np.random.default_rng(3).standard_normal((2, 1600)).astype(np.float32)
    with torch.no_grad():
        theirs = hf(torch.from_numpy(audio), output_hidden_states=True).hidden_states[18].numpy()
        out = port(torch.from_numpy(audio), output_layer=18).numpy()
    ref = np.asarray(JHubertModel(jcfg).apply(from_hf_state_dict(jcfg, hf.state_dict()),
                                              jnp.asarray(audio), output_layer=18))
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-2)
    np.testing.assert_allclose(out, theirs, atol=1e-3, rtol=1e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_normalize_input_matches_jax(masked):
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((3, 640)) * 3 + 1).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(640)[None] < np.array([[640], [333], [17]])).astype(np.int64)
    out = normalize_input(torch.from_numpy(audio), None if mask is None else torch.from_numpy(mask))
    ref = j_normalize_input(jnp.asarray(audio), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_positional_conv_is_folded_per_tap():
    """HF's positional conv normalizes over (out, in) for each tap
    (``weight_norm(dim=2)``, g ``(1, 1, K)``): the port folds it so and gets
    HF's effective weight. The codec's fold (``weight_norm(dim=0)``: the
    norm over every dim but the first) refuses the pair (g holds K entries,
    not C_out), and the norm taken its way gives another weight."""
    hf = _hf_model(HUBERT_TINY_TEST, 5)
    sd = hf.state_dict()
    g = sd[f"{POS_CONV}.parametrizations.weight.original0"]
    v = sd[f"{POS_CONV}.parametrizations.weight.original1"]
    assert g.shape == (1, 1, HUBERT_TINY_TEST.num_conv_pos_embeddings)
    effective = hf.encoder.pos_conv_embed.conv.weight.detach()
    torch.testing.assert_close(fold_pos_conv(g, v), effective, rtol=1e-6, atol=1e-6)
    port = HubertModel(HUBERT_TINY_TEST)
    load_hf_state_dict(port, sd)
    torch.testing.assert_close(port.encoder.pos_conv_embed.conv.weight, effective,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        fold_weight_norm({f"{POS_CONV}.weight_g": g.numpy(), f"{POS_CONV}.weight_v": v.numpy()})
    per_row = v * (g / torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True)))
    assert (per_row - effective).abs().max() > 0.1 * effective.abs().max()


def test_hf_state_dict_loads_strictly():
    hf = _hf_model(HUBERT_TINY_TEST, 6)
    sd = hf.state_dict()
    assert "masked_spec_embed" in sd  # training's SpecAugment vector: dropped
    port = HubertModel(HUBERT_TINY_TEST)
    load_hf_state_dict(port, sd)
    for key in ("encoder.layers.1.attention.q_proj.bias", f"{POS_CONV}.parametrizations.weight.original0"):
        partial = {k: v for k, v in sd.items() if k != key}
        with pytest.raises((KeyError, RuntimeError)):
            load_hf_state_dict(HubertModel(HUBERT_TINY_TEST), partial)
    with pytest.raises(RuntimeError):
        load_hf_state_dict(port, {**sd, "encoder.extra.weight": torch.zeros(1)})


def test_jax_params_bridge_round_trips(tiny):
    """JAX params -> HF state dict (the port's bridge) -> JAX params again
    is the identity, and the port loaded from the bridge computes what the
    JAX model computes."""
    _, jmodel, params, _ = tiny
    sd = hf_state_dict_from_jax_params(HUBERT_TINY_TEST, params)
    back = from_hf_state_dict(J_TINY, sd)["params"]
    flat = lambda tree, pre="": ({f"{pre}{k}": v for k, v in tree.items() if not isinstance(v, dict)}
                                 | {kk: vv for k, v in tree.items() if isinstance(v, dict)
                                    for kk, vv in flat(v, f"{pre}{k}/").items()})
    want, got = flat(params["params"]), flat(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    port = HubertModel(HUBERT_TINY_TEST)
    load_hf_state_dict(port, sd)
    audio = np.random.default_rng(4).standard_normal((1, 700)).astype(np.float32)
    with torch.no_grad():
        out = port(torch.from_numpy(audio), output_layer=2).numpy()
    ref = np.asarray(jmodel.apply(params, jnp.asarray(audio), output_layer=2))
    np.testing.assert_allclose(out, ref, **TOL)
