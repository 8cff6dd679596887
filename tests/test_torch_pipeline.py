"""The whole slice: the port's ``e2e_synthesize`` against edm_tts_tpu's staged
greedy chain at temperature 0 (``t2s_sample`` -> ``s2a_sample`` ->
``decode_audio``, which tests/test_pipeline_fused.py pins to the JAX fused
pipeline), and the port's independence from JAX.

Tiny models with the same weights, f32 on the CPU. Tokens and lengths:
exact. Audio: atol/rtol 1e-4.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.s2a import InjectionConformer as JInjectionConformer
from edm_tts_tpu.models.s2a import s2a_sample as j_s2a_sample
from edm_tts_tpu.models.t2s import t2s_sample as j_t2s_sample
from edm_tts_tpu_torch.pipeline import e2e_synthesize
from torch_port_parity import s2a_pair, t2s_pair

MSL = 12


@pytest.fixture(scope="module")
def models():
    return t2s_pair(seed=0), s2a_pair(seed=0)


@pytest.mark.parametrize("full_canvas", [True, False])
def test_e2e_matches_jax_staged_greedy_chain(models, full_canvas):
    (jt2s, t2s_vars, t2s), (js2a, s2a_vars, s2a) = models
    rng = np.random.default_rng(3)
    text = np.array([[b + 5 for b in b"hello"]], np.int64)
    text_len = np.array([5], np.int64)
    prompt_ac = rng.integers(0, 16, (1, 4, 4))
    prompt_sem = rng.integers(0, 8, (1, 4))
    gt = np.array([MSL]) if full_canvas else None  # else: the length predictor

    key = jax.random.PRNGKey(7)
    t2s_out = j_t2s_sample(jt2s, t2s_vars, jnp.asarray(text, jnp.int32), jnp.asarray(text_len), key,
                           pred_iters=3, temperature=0.0, max_speech_len=MSL,
                           gt_length=None if gt is None else jnp.asarray(gt), greedy=True)
    codes = j_s2a_sample(js2a, s2a_vars, t2s_out["semantic_tokens"], jnp.asarray(prompt_ac),
                         jnp.asarray(prompt_sem), key, steps=3, temperature=0.0, greedy=True,
                         semantic_valid=None if full_canvas else t2s_out["valid"])
    audio = js2a.apply(s2a_vars, codes, method=JInjectionConformer.decode_audio)

    out = e2e_synthesize(
        t2s, s2a, torch.from_numpy(text), torch.from_numpy(text_len),
        torch.from_numpy(prompt_ac), torch.from_numpy(prompt_sem), pred_iters=3, steps=3,
        temperature=0.0, max_speech_len=MSL, gt_length=None if gt is None else torch.from_numpy(gt),
        assume_full_canvas=full_canvas, greedy=True,
    )
    np.testing.assert_array_equal(out["lengths"].numpy(), np.asarray(t2s_out["lengths"]))
    np.testing.assert_array_equal(out["semantic_tokens"].numpy(), np.asarray(t2s_out["semantic_tokens"]))
    np.testing.assert_array_equal(out["acoustic_codes"].numpy(), np.asarray(codes))
    assert out["audio"].shape == audio.shape == (1, s2a.acoustic_model.decoded_length(MSL), 1)
    np.testing.assert_allclose(out["audio"].numpy(), np.asarray(audio), atol=1e-4, rtol=1e-4)


def test_port_imports_no_jax():
    code = (
        "import sys, edm_tts_tpu_torch, edm_tts_tpu_torch.pipeline, edm_tts_tpu_torch.convert\n"
        "import edm_tts_tpu_torch.kernels.build, edm_tts_tpu_torch.profile_synthesis\n"
        "import edm_tts_tpu_torch.serving, edm_tts_tpu_torch.models.quantize\n"
        "import edm_tts_tpu_torch.ops.qdense, edm_tts_tpu_torch.utils.bucketing, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'edm_tts_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    # and no import statement anywhere, lazy ones inside functions included
    root = Path(__file__).resolve().parent.parent
    for path in [root / "chip_smoke.py", *sorted((root / "edm_tts_tpu_torch").rglob("*.py"))]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad = [n for n in names if n.split(".")[0] in ("jax", "flax", "edm_tts_tpu")]
            assert not bad, (path, bad)
