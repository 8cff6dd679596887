"""The port's int8 model quantization (models/quantize.py) against
edm_tts_tpu's, on tiny models whose widths put sites on both sides of the
shape gate (``QUANT_T2S``, ``QUANT_S2A``).

The JAX float weights go to the port through ``to_torch_state_dict``; both
packages then quantize their own copy. The quantized sites and every
``kernel_q`` / ``kernel_scale`` are compared exactly: the JAX quantized tree
is turned back into reference-format tensors by the same converter, with
the int8 values (or the scales) in place of each float kernel. Logits: f32
on the CPU, atol/rtol 1e-4. The greedy t2s -> s2a chain at temperature 0 on
the int8 models: tokens and codes equal.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.quantize import quantize_s2a as j_quantize_s2a
from edm_tts_tpu.models.quantize import quantize_t2s as j_quantize_t2s
from edm_tts_tpu.models.s2a import InjectionConformer as JInjectionConformer
from edm_tts_tpu.models.s2a import s2a_sample as j_s2a_sample
from edm_tts_tpu.models.s2a.convert import to_torch_state_dict as s2a_to_torch
from edm_tts_tpu.models.t2s import TextToSemantic as JTextToSemantic
from edm_tts_tpu.models.t2s import t2s_sample as j_t2s_sample
from edm_tts_tpu.models.t2s.convert import to_torch_state_dict as t2s_to_torch
from edm_tts_tpu_torch.models.quantize import quantize_s2a, quantize_t2s
from edm_tts_tpu_torch.models.s2a import s2a_sample
from edm_tts_tpu_torch.models.t2s import build_canvas, t2s_sample
from edm_tts_tpu_torch.ops import QLinear
from torch_port_parity import QUANT_S2A, QUANT_T2S, s2a_pair, t2s_pair

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def t2s():
    jmodel, variables, model = t2s_pair(seed=0, cfg=QUANT_T2S)
    jq, jq_vars = j_quantize_t2s(jmodel, variables, "int8")
    return jq, jq_vars, quantize_t2s(model, "int8")


@pytest.fixture(scope="module")
def s2a():
    jmodel, variables, model = s2a_pair(seed=0, cfg=QUANT_S2A)
    jq, jq_vars = j_quantize_s2a(jmodel, variables, "int8")
    return jq, jq_vars, quantize_s2a(model, "int8")


def _swap_quantized(tree, fill):
    """``tree`` with each ``{kernel_q, kernel_scale}`` node's pair replaced by
    a float ``kernel = fill(q, scale)`` of the kernel's shape."""
    if not isinstance(tree, Mapping):
        return tree
    if "kernel_q" in tree:
        out = {k: v for k, v in tree.items() if k not in ("kernel_q", "kernel_scale")}
        out["kernel"] = fill(np.asarray(tree["kernel_q"]), np.asarray(tree["kernel_scale"]))
        return out
    return {k: _swap_quantized(v, fill) for k, v in tree.items()}


def _check_sites(model, to_torch, cfg, variables):
    port = {n: m for n, m in model.named_modules() if isinstance(m, QLinear)}

    def convert(fill):
        return to_torch(cfg, _swap_quantized(variables, fill))

    marked = convert(lambda q, s: np.full(q.shape, np.nan, np.float32))
    sites = {k.rsplit(".", 1)[0] for k, v in marked.items()
             if v.dtype.kind == "f" and np.isnan(v).any()}
    assert sites == set(port)
    q_sd = convert(lambda q, s: q.astype(np.float32))
    s_sd = convert(lambda q, s: np.broadcast_to(s[None, :], q.shape).astype(np.float32))
    for name, layer in port.items():
        k, n = layer.kernel_q.shape
        np.testing.assert_array_equal(q_sd[f"{name}.weight"].reshape(n, k).T,
                                      layer.kernel_q.numpy().astype(np.float32), err_msg=name)
        np.testing.assert_array_equal(s_sd[f"{name}.weight"].reshape(n, k)[:, 0],
                                      layer.kernel_scale.numpy(), err_msg=name)
    return sites


def test_t2s_sites_and_weights_equal_jax(t2s):
    jq, jq_vars, model = t2s
    sites = _check_sites(model, t2s_to_torch, jq.cfg, jq_vars)
    # 7 of 9 per block (to_q 128->96 and to_kv 128->192 stay float) in both
    # Conformers, plus pred_transform's dense; pred_head (128 -> 8) stays float
    blocks = QUANT_T2S["main_encoder_num_layers"] + QUANT_T2S["length_predictor_num_layers"]
    assert len(sites) == 7 * blocks + 1
    assert "pred_transform.0" in sites and "pred_head" not in sites
    assert not any(s.endswith(("to_q", "to_kv")) for s in sites)
    assert model.cfg.quantize == "int8"


def test_s2a_sites_and_weights_equal_jax(s2a):
    jq, jq_vars, model = s2a
    sites = _check_sites(model, s2a_to_torch, jq.cfg, jq_vars)
    assert len(sites) == 9 * QUANT_S2A["encoder_num_layers"] + 1
    assert "encoder.fine_head.0" in sites
    assert not any("project_injection" in s or "feat_proj" in s for s in sites)


def test_quantized_t2s_logits_match_jax(t2s):
    jq, jq_vars, model = t2s
    text = np.array([[b + 5 for b in b"int8"] + [0, 0], [b + 5 for b in b"quant!"]], np.int64)
    text_len, speech_len = np.array([4, 6]), np.array([8, 5])
    canvas, attention, span = build_canvas(*map(torch.from_numpy, (text, text_len, speech_len)), 8)
    tokens = np.where(span.numpy(), np.random.default_rng(0).integers(261, 269, span.shape),
                      canvas.numpy())
    j_emb = jq.apply(jq_vars, jnp.asarray(tokens, jnp.int32), method=JTextToSemantic.embed)
    ref = jq.apply(jq_vars, j_emb, jnp.asarray(attention.numpy()),
                   conv_pad_mask=jnp.asarray(attention.numpy()),
                   method=JTextToSemantic.embeddings_to_logits)
    with torch.no_grad():
        out = model.embeddings_to_logits(model.embed(torch.from_numpy(tokens)), attention,
                                         conv_pad_mask=attention)
    valid = attention.numpy()
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], **TOL)


def test_quantized_s2a_logits_match_jax(s2a):
    jq, jq_vars, model = s2a
    b, tp, t = 2, 4, 9
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, tp + t, 128)).astype(np.float32)
    valid = np.arange(tp + t)[None, :] < np.array([[11], [13]])
    ref = jq.apply(jq_vars, jnp.asarray(x), jnp.asarray(valid),
                   method=JInjectionConformer.forward_first_level)
    with torch.no_grad():
        out = model.forward_first_level(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(out[valid], np.asarray(ref)[valid], **TOL)
    mask_time = np.arange(tp + t)[None, :].repeat(b, 0) >= tp
    inj = rng.standard_normal((2, b, tp + t, model.cfg.codec.latent_dim)).astype(np.float32)
    ref = jq.apply(jq_vars, jnp.asarray(x), prompt_injections=jnp.asarray(inj),
                   mask_time=jnp.asarray(mask_time), pad_mask=jnp.asarray(valid),
                   generated_start=tp, method=JInjectionConformer.forward_logits)
    with torch.no_grad():
        out = model.forward_logits(torch.from_numpy(x), prompt_injections=torch.from_numpy(inj),
                                   mask_time=torch.from_numpy(mask_time),
                                   pad_mask=torch.from_numpy(valid), generated_start=tp).numpy()
    keep = valid[:, tp:]
    np.testing.assert_allclose(out.transpose(0, 2, 1, 3)[keep],
                               np.asarray(ref).transpose(0, 2, 1, 3)[keep], **TOL)


@pytest.mark.parametrize("gt_length", [np.array([7, 5]), None])
def test_greedy_chain_on_int8_models_matches_jax(t2s, s2a, gt_length):
    (jt2s, t2s_vars, t2s_model), (js2a, s2a_vars, s2a_model) = t2s, s2a
    rng = np.random.default_rng(2)
    text = np.array([[b + 5 for b in b"hello"] + [0], [b + 5 for b in b"int8 !"]], np.int64)
    text_len = np.array([5, 6])
    prompt_ac, prompt_sem = rng.integers(0, 16, (2, 4, 4)), rng.integers(0, 8, (2, 4))
    key = jax.random.PRNGKey(3)
    gt = None if gt_length is None else jnp.asarray(gt_length)
    j_out = j_t2s_sample(jt2s, t2s_vars, jnp.asarray(text, jnp.int32), jnp.asarray(text_len), key,
                         pred_iters=3, temperature=0.0, max_speech_len=8, gt_length=gt,
                         greedy=True)
    j_codes = j_s2a_sample(js2a, s2a_vars, j_out["semantic_tokens"], jnp.asarray(prompt_ac),
                           jnp.asarray(prompt_sem), key, steps=3, temperature=0.0, greedy=True,
                           semantic_valid=j_out["valid"])
    out = t2s_sample(t2s_model, torch.from_numpy(text), torch.from_numpy(text_len),
                     pred_iters=3, temperature=0.0, max_speech_len=8, greedy=True,
                     gt_length=None if gt_length is None else torch.from_numpy(gt_length))
    codes = s2a_sample(s2a_model, out["semantic_tokens"], torch.from_numpy(prompt_ac),
                       torch.from_numpy(prompt_sem), steps=3, temperature=0.0, greedy=True,
                       semantic_valid=out["valid"])
    np.testing.assert_array_equal(out["lengths"].numpy(), np.asarray(j_out["lengths"]))
    np.testing.assert_array_equal(out["semantic_tokens"].numpy(), np.asarray(j_out["semantic_tokens"]))
    valid = out["valid"].numpy()
    np.testing.assert_array_equal(codes.numpy().transpose(0, 2, 1)[valid],
                                  np.asarray(j_codes).transpose(0, 2, 1)[valid])
