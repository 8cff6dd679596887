"""The port's text->semantic model and sampler against edm_tts_tpu's.

Same weights on both sides (``to_torch_state_dict`` -> strict load), f32 on
the CPU. Logits: atol/rtol 1e-4. Tokens, lengths and canvases: exact. The
samplers are compared greedy at temperature 0 (greedy alone still re-masks
with gumbel noise) and once sampled, with the noise JAX draws rebuilt here
from the same key splits and handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.t2s import TextToSemantic as JTextToSemantic
from edm_tts_tpu.models.t2s import build_canvas as j_build_canvas
from edm_tts_tpu.models.t2s import t2s_sample as j_t2s_sample
from edm_tts_tpu_torch.models.t2s import build_canvas, t2s_sample
from torch_port_parity import t2s_pair

TOL = dict(atol=1e-4, rtol=1e-4)
TEXT = np.array([[b + 5 for b in b"hello"] + [0, 0], [b + 5 for b in b"tts ok!"]], np.int64)
TEXT_LEN = np.array([5, 7], np.int64)
MSL = 12


@pytest.fixture(scope="module")
def t2s():
    return t2s_pair(seed=0)


def test_canvas_and_logits_match_jax(t2s):
    jmodel, variables, model = t2s
    speech_len = np.array([12, 9], np.int64)
    canvas, attention, span = build_canvas(*map(torch.from_numpy, (TEXT, TEXT_LEN, speech_len)), MSL)
    j_canvas, j_attention, j_span = j_build_canvas(
        jnp.asarray(TEXT, jnp.int32), jnp.asarray(TEXT_LEN), jnp.asarray(speech_len), MSL)
    for a, b in ((canvas, j_canvas), (attention, j_attention), (span, j_span)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # fill the speech span with semantic ids so the logits see real tokens
    rng = np.random.default_rng(0)
    tokens = np.where(span.numpy(), rng.integers(261, 269, span.shape), canvas.numpy())
    j_emb = jmodel.apply(variables, jnp.asarray(tokens, jnp.int32), method=JTextToSemantic.embed)
    ref = jmodel.apply(variables, j_emb, j_attention, conv_pad_mask=j_attention,
                       method=JTextToSemantic.embeddings_to_logits)
    with torch.no_grad():
        emb = model.embed(torch.from_numpy(tokens))
        out = model.embeddings_to_logits(emb, attention, conv_pad_mask=attention)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), atol=0, rtol=0)
    valid = attention.numpy()
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], **TOL)


def test_predict_log_length_matches_jax(t2s):
    jmodel, variables, model = t2s
    mask = np.arange(TEXT.shape[1])[None, :] < TEXT_LEN[:, None]
    ref = jmodel.apply(variables, jnp.asarray(TEXT, jnp.int32), jnp.asarray(mask), mask_conv=True,
                       method=JTextToSemantic.predict_log_length)
    with torch.no_grad():
        out = model.predict_log_length(torch.from_numpy(TEXT), torch.from_numpy(mask), mask_conv=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _both(t2s, key, **kw):
    jmodel, variables, model = t2s
    gt = kw.pop("gt_length", None)
    ref = j_t2s_sample(jmodel, variables, jnp.asarray(TEXT, jnp.int32), jnp.asarray(TEXT_LEN), key,
                       max_speech_len=MSL, gt_length=None if gt is None else jnp.asarray(gt),
                       **{k: v for k, v in kw.items() if k != "noise"})
    out = t2s_sample(model, torch.from_numpy(TEXT), torch.from_numpy(TEXT_LEN),
                     max_speech_len=MSL, gt_length=None if gt is None else torch.from_numpy(gt), **kw)
    for name in ("semantic_tokens", "lengths", "valid"):
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]), err_msg=name)
    return out


@pytest.mark.parametrize("gt_length", [np.array([12, 8]), None])
def test_greedy_sampler_matches_jax(t2s, gt_length):
    out = _both(t2s, jax.random.PRNGKey(1), pred_iters=4, temperature=0.0, greedy=True,
                gt_length=gt_length)
    if gt_length is not None:
        assert out["lengths"].tolist() == [12, 8]


def test_sampled_run_matches_jax_with_replayed_noise(t2s):
    key = jax.random.PRNGKey(5)
    pred_iters = 4
    b, length, v = TEXT.shape[0], TEXT.shape[1] + 4 + MSL, 8
    sample, mask = [], []
    for k in jax.random.split(key, pred_iters - 1):  # t2s/sampler.py:136,160
        k_sample, k_mask = jax.random.split(k)
        sample.append(np.asarray(jax.random.gumbel(k_sample, (b, length, v), jnp.float32)))
        mask.append(np.asarray(jax.random.gumbel(k_mask, (b, length))))
    noise = {"sample": torch.from_numpy(np.stack(sample)), "mask": torch.from_numpy(np.stack(mask))}
    _both(t2s, key, pred_iters=pred_iters, temperature=1.0, gt_length=np.array([12, 10]), noise=noise)
