"""The port's semantic->acoustic model and sampler against edm_tts_tpu's.

Same weights on both sides, the codec included (``to_torch_state_dict`` ->
strict load), f32 on the CPU. Logits: atol/rtol 1e-4. Codes: exact. The
sampler is compared greedy at temperature 0, and once sampled with the
positional noise JAX draws rebuilt here from the same key splits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.s2a import InjectionConformer as JInjectionConformer
from edm_tts_tpu.models.s2a import s2a_sample as j_s2a_sample
from edm_tts_tpu.ops.masking import positional_gumbel, positional_keys
from edm_tts_tpu_torch.models.s2a import s2a_sample
from torch_port_parity import s2a_pair

TOL = dict(atol=1e-4, rtol=1e-4)
B, T, TP, Q, N = 2, 10, 4, 4, 16


@pytest.fixture(scope="module")
def s2a():
    return s2a_pair(seed=0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 8, (B, T)), rng.integers(0, N, (B, Q, TP)), rng.integers(0, 8, (B, TP)))


def test_first_level_logits_match_jax(s2a):
    jmodel, variables, model = s2a
    x = np.random.default_rng(1).standard_normal((B, 13, 32)).astype(np.float32)
    valid = np.arange(13)[None, :] < np.array([[9], [13]])
    ref = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(valid),
                       method=JInjectionConformer.forward_first_level)
    with torch.no_grad():
        out = model.forward_first_level(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(out[valid], np.asarray(ref)[valid], **TOL)


def test_forward_logits_with_dynamic_injection_match_jax(s2a, inputs):
    jmodel, variables, model = s2a
    _, prompt_ac, _ = inputs
    x = np.random.default_rng(2).standard_normal((B, TP + T, 32)).astype(np.float32)
    ac_p = jmodel.apply(variables, jnp.asarray(prompt_ac),
                        method=JInjectionConformer.acoustic_features_unreduced)
    cum = jnp.cumsum(ac_p, axis=1)
    inj = jnp.stack([jnp.concatenate([cum[:, i], jnp.zeros((B, T, cum.shape[-1]))], axis=1)
                     for i in range(2)])
    mask_time = jnp.arange(TP + T)[None, :].repeat(B, 0) >= TP
    ref = jmodel.apply(variables, jnp.asarray(x), prompt_injections=inj, mask_time=mask_time,
                       generated_start=TP, method=JInjectionConformer.forward_logits)
    with torch.no_grad():
        out = model.forward_logits(torch.from_numpy(x), prompt_injections=torch.from_numpy(np.array(inj)),
                                   mask_time=torch.from_numpy(np.array(mask_time)), generated_start=TP)
    assert out.shape == ref.shape == (B, Q, T, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _both(s2a, inputs, key, **kw):
    jmodel, variables, model = s2a
    sem, prompt_ac, prompt_sem = inputs
    valid = kw.pop("semantic_valid", None)
    noise = kw.pop("noise", None)
    ref = j_s2a_sample(jmodel, variables, jnp.asarray(sem), jnp.asarray(prompt_ac),
                       jnp.asarray(prompt_sem), key,
                       semantic_valid=None if valid is None else jnp.asarray(valid), **kw)
    out = s2a_sample(model, *map(torch.from_numpy, inputs),
                     semantic_valid=None if valid is None else torch.from_numpy(valid), noise=noise, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    return out


def test_greedy_sampler_on_a_padded_canvas_matches_jax(s2a, inputs):
    # the full canvas (no semantic_valid) is covered greedy by
    # test_torch_pipeline.py and sampled below
    valid = np.arange(T)[None, :] < np.array([[7], [10]])
    _both(s2a, inputs, jax.random.PRNGKey(0), steps=4, temperature=0.0, greedy=True,
          semantic_valid=valid)


def test_sampled_run_matches_jax_with_replayed_noise(s2a, inputs):
    key = jax.random.PRNGKey(11)
    steps = 4
    sample, mask = [], []
    for k in jax.random.split(key, steps - 1):  # s2a/sampler.py:135,168
        k_sample, k_mask = jax.random.split(k)
        keys = positional_keys(k_sample, B, T)
        sample.append(np.asarray(jax.vmap(jax.vmap(lambda kk: jax.random.gumbel(kk, (N,))))(keys)))
        mask.append(np.asarray(positional_gumbel(k_mask, B, T)))
    noise = {"sample": torch.from_numpy(np.stack(sample)), "mask": torch.from_numpy(np.stack(mask))}
    _both(s2a, inputs, key, steps=steps, temperature=1.0, noise=noise)
