"""The engine's data-parallel ``mesh`` (JAX tests/test_serving.py
``test_engine_dp_mesh_matches_single_device`` and its quantized twin): two
replicas on the CPU split each batch of the bucket of 4 and give the audio
of one engine at temperature 1: in f32 with the length predictor (so the
s2a canvas must be taken from every replica's rows) and with w8a8 weights
and given lengths (so every row's positional noise must be drawn at its
row of the whole batch); a bucket the replicas do not divide raises
ValueError. Against the JAX engine on a (data 2) mesh of the virtual CPU
devices, over the same weights and tokenizer, both packages' samplers
switched to greedy at temperature 0 as in tests/test_torch_serving.py:
lengths exact, waveforms within its atol/rtol 1e-4, in f32 and with
weight-only int8, the modes that file holds one engine to. (With w8a8 and
the given lengths one row's audio differs from JAX's by up to 0.25 at
greedy, on one port engine as on the replicas: the activations' int8
rounding turns on summation-order differences.)
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.codec import Codec as JCodec
from edm_tts_tpu.models.quantize import quantize_s2a as j_quantize_s2a
from edm_tts_tpu.models.quantize import quantize_t2s as j_quantize_t2s
from edm_tts_tpu.models.tokenizer.audio_tokenizer import AudioTokenizer as JAudioTokenizer
from edm_tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from edm_tts_tpu.serving.engine import TTSEngine as JTTSEngine
from edm_tts_tpu_torch.serving.engine import TTSEngine
from test_torch_serving import TOL, _prompt, greedy  # noqa: F401 (greedy is a fixture)
from torch_port_parity import QUANT_S2A, QUANT_T2S, hubert_pair, s2a_pair, t2s_pair

OPTS = dict(pred_iters=3, s2a_steps=3, temperature=1.0, max_speech_len=16, text_bucket=8,
            length_bucket=8, batch_buckets=(4,))
TEXTS = ["hi", "hello there", "tiny tts!"]


@pytest.fixture(autouse=True, scope="module")
def one_thread_per_replica():
    """Two replica threads with torch's whole thread pool each would spin on
    each other's cores; one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=1)
def _models():
    return t2s_pair(seed=0, cfg=QUANT_T2S)[2], s2a_pair(seed=0, cfg=QUANT_S2A)[2]


def _engine(quantize, **kw):
    """An engine over copies of the same models (``from_models`` quantizes
    the models it is given in place)."""
    t2s, s2a = (copy.deepcopy(m) for m in _models())
    engine = TTSEngine.from_models(t2s, s2a, device="cpu", quantize=quantize, **{**OPTS, **kw})
    rng = np.random.default_rng(0)
    engine.register_speaker_codes("p", rng.integers(0, 16, (1, 4, 5)), rng.integers(0, 8, (1, 5)))
    return engine


@pytest.mark.parametrize("quantize,gt_lengths", [("none", None), ("w8a8", [8, 6, 12])])
def test_two_replicas_give_the_single_engines_audio(quantize, gt_lengths):
    single, two = _engine(quantize), _engine(quantize, mesh=["cpu", "cpu"])
    one = single.synthesize(TEXTS, "p", seed=5, gt_lengths=gt_lengths)
    assert len(two.replicas) == 2
    out = two.synthesize(TEXTS, "p", seed=5, gt_lengths=gt_lengths)
    assert len(out) == 3
    for a, b in zip(out, one):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_buckets_not_divisible_by_the_replicas_raise():
    with pytest.raises(ValueError, match="divisible"):
        _engine("none", batch_buckets=(1, 2), mesh=["cpu", "cpu"])


@pytest.mark.parametrize("quantize,gt_lengths", [("none", None), ("int8", [9, 16, 4])])
def test_two_replicas_match_the_jax_engine_on_a_data_mesh(greedy, quantize, gt_lengths):
    jt2s, t2s_vars, t2s = t2s_pair(seed=0, cfg=QUANT_T2S)
    js2a, s2a_vars, s2a = s2a_pair(seed=0, cfg=QUANT_S2A)
    jsem, sem_params, sem = hubert_pair(seed=0, num_clusters=QUANT_S2A["num_semantic_tokens"])
    if quantize != "none":
        jt2s, t2s_vars = j_quantize_t2s(jt2s, t2s_vars, quantize)
        js2a, s2a_vars = j_quantize_s2a(js2a, s2a_vars, quantize)
    opts = {**OPTS, "temperature": 0.0}
    j_engine = JTTSEngine.from_models(
        JAudioTokenizer(JCodec(js2a.cfg.codec), jsem), {"params": s2a_vars["params"]["codec"]},
        sem_params, js2a, s2a_vars, jt2s, t2s_vars,
        mesh=j_make_mesh(2, 1, devices=jax.devices()[:2]), **opts)
    engine = TTSEngine.from_models(t2s, s2a, sem, device="cpu", quantize=quantize,
                                   mesh=["cpu", "cpu"], **opts)
    ac, sc = _prompt()
    j_engine.register_speaker_codes("p", jnp.asarray(ac), jnp.asarray(sc))
    engine.register_speaker_codes("p", ac, sc)
    ref = j_engine.synthesize(TEXTS, "p", seed=3, gt_lengths=gt_lengths)
    out = engine.synthesize(TEXTS, "p", seed=3, gt_lengths=gt_lengths)
    assert len(engine.replicas) == 2 and len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
