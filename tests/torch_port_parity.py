"""Shared helpers of the tests/test_torch_*.py parity tests.

Each helper builds a tiny model of the JAX package from a seed, exports its
weights with the package's own ``to_torch_state_dict`` (numpy, reference
key names) and loads them into the port with ``load_reference_state_dict``.
The port never calls the JAX side; only these tests hold both.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from edm_tts_tpu.models.codec import Codec as JCodec
from edm_tts_tpu.models.codec import CodecConfig as JCodecConfig
from edm_tts_tpu.models.codec.convert import to_torch_state_dict as codec_to_torch
from edm_tts_tpu.models.s2a import InjectionConformer as JInjectionConformer
from edm_tts_tpu.models.s2a import S2AConfig as JS2AConfig
from edm_tts_tpu.models.s2a.convert import to_torch_state_dict as s2a_to_torch
from edm_tts_tpu.models.t2s import T2SConfig as JT2SConfig
from edm_tts_tpu.models.t2s import TextToSemantic as JTextToSemantic
from edm_tts_tpu.models.t2s.convert import to_torch_state_dict as t2s_to_torch
from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
from edm_tts_tpu_torch.models.t2s import T2SConfig, TextToSemantic

# the tiny configs of tests/test_pipeline_fused.py; the codec keeps the real
# strides (8, 5, 4, 2) with a narrow decoder (channels 64 -> 32, 16, 8, 4)
TINY_CODEC = dict(encoder_dim=4, decoder_dim=64, n_codebooks=4, codebook_size=16,
                  codebook_dim=4, quantizer_dropout=0.0)
TINY_S2A = dict(hidden_size=32, num_semantic_tokens=8, encoder_num_heads=4,
                encoder_num_layers=4, injection_layers=(1, 2), encoder_attn_dropout=0.0,
                encoder_ff_dropout=0.0, encoder_conv_dropout=0.0)
# heads x dim_head (2 x 12 = 24) != hidden 32: the t2s model's quirk
TINY_T2S = dict(hidden_size=32, semantic_vocab_size=8, main_encoder_num_heads=2,
                main_encoder_dim_head=12, main_encoder_num_layers=2,
                length_predictor_num_heads=2, length_predictor_dim_head=12,
                length_predictor_num_layers=1)
# widths that put the int8 sites (QDense / QLinear) on both sides of the
# shape gate K % 32 == 0 and N % 128 == 0: at hidden 128 every s2a site and
# the t2s feed-forwards, to_out (96 -> 128), the pointwise convs and the
# pred_transform dense pass; the t2s to_q (128 -> 96), to_kv (128 -> 192)
# and pred_head (128 -> 8) stay float
QUANT_S2A = {**TINY_S2A, "hidden_size": 128, "encoder_num_heads": 4}
QUANT_T2S = {**TINY_T2S, "hidden_size": 128, "main_encoder_dim_head": 48,
             "length_predictor_dim_head": 48}


def as_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def random_variables(init, seed: int) -> dict:
    """Variables of the shapes ``init(key)`` would make, filled from numpy.

    ``jax.eval_shape`` only traces, so this skips compiling the init
    (seconds per model). Scales follow a fresh model's: U(+-1/sqrt(fan_in))
    kernels, N(0, 1) embeddings and codebooks, and norm scales, snake
    alphas around 1 and weight-norm magnitudes around a fresh ``||v||`` (not
    exactly those, so the tests exercise them).
    """
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name in ("alpha", "alpha1", "alpha2", "scale", "weight"):
            x = rng.uniform(0.7, 1.3, shape)
        elif name == "g" or name.endswith("_g"):  # a fresh ||v|| is ~1/sqrt(3)
            x = rng.uniform(0.4, 0.75, shape)
        elif name in ("embedding", "codebook", "mask_token", "length_token"):
            x = rng.standard_normal(shape)
        elif name in ("bias", "b", "logits_b", "dw_bias") or name.endswith("_b"):
            x = rng.standard_normal(shape) * 0.05
        else:  # kernels: the contracted axes are all but the last
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            if name == "logits_w":
                fan_in = shape[1]
            x = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        return jnp.asarray(x, jnp.float32)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def codec_pair(seed: int = 0):
    """(JAX codec, its variables, port codec) with the same weights."""
    jcfg = JCodecConfig(**TINY_CODEC)
    jmodel = JCodec(jcfg)
    variables = random_variables(lambda r: jmodel.init(r, jnp.zeros((1, 640, 1))), seed)
    model = Codec(CodecConfig(**TINY_CODEC))
    load_reference_state_dict(model, codec_to_torch(jcfg, variables))
    return jmodel, variables, model


def t2s_pair(seed: int = 0, cfg: dict = TINY_T2S):
    """(JAX t2s, its variables, port t2s) with the same weights."""
    jcfg = JT2SConfig(**cfg)
    jmodel = JTextToSemantic(jcfg)
    variables = random_variables(lambda r: jmodel.init(
        r, jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), bool), jnp.zeros((1, 16), bool),
        jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool), jnp.ones((1,)),
        mask_rng=r, train=False,
    ), seed)
    port_cfg = T2SConfig(**cfg)
    for name in ("main_encoder_config", "length_predictor_config"):
        assert (dataclasses.asdict(getattr(port_cfg, name))
                == dataclasses.asdict(getattr(jcfg, name)))
    model = TextToSemantic(port_cfg)
    load_reference_state_dict(model, t2s_to_torch(jcfg, variables))
    return jmodel, variables, model


def s2a_pair(seed: int = 0, cfg: dict = TINY_S2A):
    """(JAX s2a with a full codec grafted in, its variables, port s2a)."""
    jcfg = JS2AConfig(**cfg, codec=JCodecConfig(**TINY_CODEC))
    jmodel = JInjectionConformer(jcfg)
    variables = random_variables(lambda r: jmodel.init(
        r, jnp.zeros((1, 4, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32),
        mask_rng=r, train=False,
    ), seed)
    _, codec_vars, _ = codec_pair(seed + 1)
    variables = {"params": {**variables["params"], "codec": codec_vars["params"]}}
    port_cfg = S2AConfig(**cfg, codec=CodecConfig(**TINY_CODEC))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jcfg)
    # the port's encoder_config carries S2AConfig.remat_policy, which the JAX
    # s2a model reads from S2AConfig itself
    assert (dataclasses.asdict(port_cfg.encoder_config)
            == {**dataclasses.asdict(jcfg.encoder_config), "remat_policy": jcfg.remat_policy})
    model = InjectionConformer(port_cfg)
    load_reference_state_dict(model, s2a_to_torch(jcfg, variables))
    return jmodel, variables, model


# a HuBERT with the real conv strides (downsample 320, so its frames line up
# with the codec's), narrow and two layers deep
TINY_HUBERT = dict(conv_dim=(8,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                   conv_stride=(5, 2, 2, 2, 2, 2, 2), hidden_size=16, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=32, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)


def hubert_pair(cfg: dict = TINY_HUBERT, seed: int = 0, output_layer: int = 1,
                num_clusters: int = 8):
    """(JAX SemanticTokenizerHubert, its params, port SemanticTokenizerHubert)
    with the same weights, carried across by the port's
    ``hf_state_dict_from_jax_params``, and the same centroids: frames of the
    port's own layer-``output_layer`` states on a seeded waveform, so that
    the ids spread over the clusters as trained centroids make them."""
    from edm_tts_tpu.models.hubert import HubertConfig as JHubertConfig
    from edm_tts_tpu.models.hubert import HubertModel as JHubertModel
    from edm_tts_tpu.models.tokenizer import SemanticTokenizerHubert as JSemantic
    from edm_tts_tpu_torch.models.hubert import HubertConfig, hf_state_dict_from_jax_params
    from edm_tts_tpu_torch.models.hubert import load_hf_state_dict
    from edm_tts_tpu_torch.models.tokenizer import SemanticTokenizerHubert

    jcfg = JHubertConfig(**cfg)
    variables = random_variables(lambda r: JHubertModel(jcfg).init(r, jnp.zeros((1, 1280))), seed)
    port = SemanticTokenizerHubert(HubertConfig(**cfg), output_layer=output_layer,
                                   num_clusters=num_clusters)
    load_hf_state_dict(port.hubert, hf_state_dict_from_jax_params(port.config, variables))
    rng = np.random.default_rng(seed + 100)
    wav = torch.from_numpy(rng.standard_normal((1, 320 * (num_clusters + 4))).astype(np.float32))
    with torch.no_grad():
        frames = port.hidden_states(wav)[0]
    pick = rng.choice(frames.shape[0], num_clusters, replace=False)
    centers = frames[pick].numpy() + 0.05 * rng.standard_normal((num_clusters, frames.shape[1]))
    port.cluster_centers.copy_(torch.from_numpy(centers.astype(np.float32)))
    jsem = JSemantic(jcfg, output_layer=output_layer)
    return jsem, jsem.make_params(variables, centers.astype(np.float32)), port


def argmin_gap(d: torch.Tensor) -> float:
    """The least gap between the smallest and second-smallest entry of the
    last axis of ``d``: ids compared across the two packages are only
    meaningful where it exceeds the ~6e-3 cross-implementation noise."""
    two = torch.topk(d.detach().reshape(-1, d.shape[-1]), 2, dim=-1, largest=False).values
    return float((two[:, 1] - two[:, 0]).min())
