"""The port's serving slice against edm_tts_tpu's: TTSEngine, the bucketing
helpers, long-form chunking, DynamicBatcher and TTSServer.

The engines run the same tiny weights (``QUANT_T2S`` / ``QUANT_S2A``, so
that ``quantize="int8"`` has sites on both sides of the shape gate, and the
``TINY_HUBERT`` semantic tokenizer), f32 on the CPU, at temperature 0 with
both packages' samplers switched to greedy inside the test (the port cannot
reproduce ``jax.random``'s streams). Lengths and prompt codes: exact.
Waveforms: atol 1e-4 (same math through two samplers and ~15
convolutions, other summation order). The host-side helpers are pinned
equal to the JAX package's on the same inputs.
"""

import base64
import functools
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import edm_tts_tpu.models.s2a as j_s2a_pkg
import edm_tts_tpu.models.t2s as j_t2s_pkg
import edm_tts_tpu_torch.serving.engine as engine_mod
from edm_tts_tpu.models.codec import Codec as JCodec
from edm_tts_tpu.models.quantize import quantize_s2a as j_quantize_s2a
from edm_tts_tpu.models.quantize import quantize_t2s as j_quantize_t2s
from edm_tts_tpu.models.tokenizer.audio_tokenizer import AudioTokenizer as JAudioTokenizer
from edm_tts_tpu.serving import batcher as j_batcher
from edm_tts_tpu.serving import chunking as j_chunking
from edm_tts_tpu.serving.engine import TTSEngine as JTTSEngine
from edm_tts_tpu.utils import bucketing as j_bucketing
from edm_tts_tpu_torch.models.s2a import s2a_sample
from edm_tts_tpu_torch.models.tokenizer import AudioTokenizer
from edm_tts_tpu_torch.serving import TTSEngine, TTSServer, batcher, chunking
from edm_tts_tpu_torch.utils import bucketing
from torch_port_parity import QUANT_S2A, QUANT_T2S, hubert_pair, s2a_pair, t2s_pair

TOL = dict(atol=1e-4, rtol=1e-4)
OPTS = dict(pred_iters=3, s2a_steps=3, temperature=0.0, max_speech_len=16, text_bucket=8,
            length_bucket=8, batch_buckets=(1, 2, 4))
TEXTS = ["hi", "hello there", "tiny tts!"]


def _prompt(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, (1, 4, 5)), rng.integers(0, 8, (1, 5))


@pytest.fixture
def greedy(monkeypatch):
    """Both packages' samplers take the argmax (re-masking is deterministic
    at temperature 0)."""
    monkeypatch.setattr(j_t2s_pkg, "t2s_sample", functools.partial(j_t2s_pkg.t2s_sample, greedy=True))
    monkeypatch.setattr(j_s2a_pkg, "s2a_sample", functools.partial(j_s2a_pkg.s2a_sample, greedy=True))
    monkeypatch.setattr(engine_mod, "t2s_sample",
                        functools.partial(engine_mod.t2s_sample, greedy=True))
    monkeypatch.setattr(engine_mod, "s2a_sample",
                        functools.partial(engine_mod.s2a_sample, greedy=True))


def _engines(quantize: str):
    """(JAX engine, port engine) over the same weights, with the same
    semantic tokenizer, one speaker "p" registered as codes."""
    jt2s, t2s_vars, t2s = t2s_pair(seed=0, cfg=QUANT_T2S)
    js2a, s2a_vars, s2a = s2a_pair(seed=0, cfg=QUANT_S2A)
    jsem, sem_params, sem = hubert_pair(seed=0, num_clusters=QUANT_S2A["num_semantic_tokens"])
    if quantize != "none":
        jt2s, t2s_vars = j_quantize_t2s(jt2s, t2s_vars, quantize)
        js2a, s2a_vars = j_quantize_s2a(js2a, s2a_vars, quantize)
    jcodec = JCodec(js2a.cfg.codec)
    j_engine = JTTSEngine.from_models(
        JAudioTokenizer(jcodec, jsem), {"params": s2a_vars["params"]["codec"]}, sem_params,
        js2a, s2a_vars, jt2s, t2s_vars, **OPTS)
    engine = TTSEngine.from_models(t2s, s2a, sem, device="cpu", quantize=quantize, **OPTS)
    ac, sem = _prompt()
    j_engine.register_speaker_codes("p", jnp.asarray(ac), jnp.asarray(sem))
    engine.register_speaker_codes("p", ac, sem)
    return j_engine, engine


@pytest.fixture(scope="module", params=["none", "int8"])
def engines(request):
    return _engines(request.param)


@pytest.fixture(scope="module")
def int8_engine():
    return _engines("int8")[1]


@pytest.mark.parametrize("gt_lengths", [[9, 16, 4], None])
def test_engine_matches_jax_engine(engines, greedy, gt_lengths):
    j_engine, engine = engines
    ref = j_engine.synthesize(TEXTS, "p", seed=3, gt_lengths=gt_lengths)
    out = engine.synthesize(TEXTS, "p", seed=3, gt_lengths=gt_lengths)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    if gt_lengths is not None:
        assert [len(w) for w in out] == [n * engine.hop_length for n in gt_lengths]
    assert engine.sample_rate == j_engine.sample_rate
    assert engine.hop_length == j_engine.tokenizer.downsample_factor
    assert engine.speakers() == j_engine.speakers() == ("p",)


def test_engine_bucketed_rows_equal_exact_size_runs(int8_engine, greedy):
    """Each row of a bucketed batch (text, canvas and batch padded) gives
    the waveform of its own batch-1 run on smaller buckets."""
    engine = int8_engine
    batch = engine.synthesize(TEXTS, "p", seed=1, gt_lengths=[5, 14, 9])
    for text, n, wav in zip(TEXTS, [5, 14, 9], batch):
        alone = engine.synthesize([text], "p", seed=1, gt_lengths=[n])[0]
        np.testing.assert_allclose(wav, alone, **TOL)


def test_padded_s2a_canvas_samples_like_the_exact_one():
    """The port's positional noise keeps bucketing exact while sampling at
    temperature 1: codes at valid positions of a padded canvas equal the
    exact-size canvas's (tests/test_bucketed_inference.py for JAX)."""
    _, _, model = s2a_pair(seed=1)
    rng = np.random.default_rng(0)
    b, n, pad, tp = 2, 10, 6, 4
    sem = torch.from_numpy(rng.integers(0, 8, (b, n + pad)))
    acp, semp = torch.from_numpy(rng.integers(0, 16, (b, 4, tp))), torch.from_numpy(rng.integers(0, 8, (b, tp)))
    exact = s2a_sample(model, sem[:, :n], acp, semp, torch.Generator().manual_seed(7), steps=3)
    valid = (torch.arange(n + pad)[None, :] < n).expand(b, -1)
    padded = s2a_sample(model, sem, acp, semp, torch.Generator().manual_seed(7), steps=3,
                        semantic_valid=valid)
    torch.testing.assert_close(padded[:, :, :n], exact, rtol=0, atol=0)


def test_register_speaker_from_a_wav_is_not_ported(int8_engine, monkeypatch):
    """Registering from a wav needs the semantic tokenizer: an engine built
    without one (codes only, ``register_speaker_codes``) refuses, as do an
    empty wav and a rate that is not positive."""
    with pytest.raises(ValueError, match="empty"):
        int8_engine.register_speaker("q", np.zeros(0, np.float32), 16000)
    with pytest.raises(ValueError, match="sample rate 0"):
        int8_engine.register_speaker("q", np.zeros(1600, np.float32), 0)
    monkeypatch.setattr(int8_engine, "tokenizer", AudioTokenizer(int8_engine.tokenizer.codec, None))
    with pytest.raises(ValueError, match="register_speaker_codes"):
        int8_engine.register_speaker("q", np.zeros(1600, np.float32), 16000)
    assert "q" not in int8_engine.speakers()


@pytest.mark.parametrize("sr,n", [(24000, 9601), (16000, 4000)])
def test_register_speaker_matches_jax_engine(sr, n):
    """A wav at 24 kHz (resampled) or 16 kHz: the port's prompt codes equal
    the JAX engine's, token for token."""
    j_engine, engine = _engines("none")
    t = np.arange(n) / sr
    wav = (0.2 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(n).standard_normal(n))
    wav = wav.astype(np.float32)
    j_engine.register_speaker("w", wav, sr)
    engine.register_speaker("w", wav, sr)
    mine, theirs = engine.prompt("w"), j_engine._speakers["w"]
    tok = engine.tokenizer
    frames = int(tok.get_code_lengths(tok.pad(np.zeros(-(-n * 16000 // sr))).shape[-1]))
    assert mine.acoustic_codes.shape == (1, 4, frames) and mine.semantic_codes.shape == (1, frames)
    np.testing.assert_array_equal(mine.acoustic_codes.numpy(), np.asarray(theirs.acoustic_codes))
    np.testing.assert_array_equal(mine.semantic_codes.numpy(), np.asarray(theirs.semantic_codes))
    assert engine.speakers() == j_engine.speakers() == ("p", "w")


def test_bucketing_and_chunking_equal_jax():
    for n in (0, 1, 63, 64, 65, 1201, 1249, 2000):
        for mult, cap in ((64, None), (64, 1250), (8, 16)):
            assert bucketing.bucket_length(n, mult, cap) == j_bucketing.bucket_length(n, mult, cap)
    for n in (1, 2, 3, 5, 16):
        assert bucketing.bucket_batch(n, (1, 2, 4, 8, 16)) == j_bucketing.bucket_batch(n, (16, 1, 4, 2, 8))
    with pytest.raises(ValueError):
        bucketing.bucket_batch(17, (1, 16))
    for m in (1, 100, 1250, 5000):
        assert chunking.default_chunk_chars(m) == j_chunking.default_chunk_chars(m)
    text = ("First sentence here. Second one!  A question?  An ellipsis… then a "
            "clause; another: and a verylongwordwithoutanyspacesatallthatmustbecut end.")
    for max_chars in (1, 7, 20, 40, 300):
        assert chunking.split_text(text, max_chars) == j_chunking.split_text(text, max_chars)
    for bad in (("", 10), ("text", 0)):
        with pytest.raises(ValueError):
            chunking.split_text(*bad)
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.5 for n in (800, 300, 40, 1200)]
    tone = np.sin(np.linspace(0, 40, 1000)).astype(np.float32)  # a correlated joint
    for ws in (wavs, [tone, tone]):
        for kw in ({}, {"crossfade_ms": 10.0}, {"crossfade_ms": 0.0}, {"gap_ms": 5.0}):
            np.testing.assert_array_equal(chunking.join_waveforms(ws, 16000, **kw),
                                          j_chunking.join_waveforms(ws, 16000, **kw))


def _engine_calls(module):
    """The engine calls ``module.DynamicBatcher`` makes for a fixed backlog."""
    calls, release = [], threading.Event()

    def synth(texts, speaker, seed=0, gt_lengths=None):
        if texts == ["blocker"]:
            release.wait(30)
        calls.append((list(texts), speaker, seed, gt_lengths))
        return [np.full(len(t), i, np.float32) for i, t in enumerate(texts)]

    b = module.DynamicBatcher(synth, max_batch=2, max_wait_ms=50, lookahead=4)
    try:
        b.submit(module.Request("blocker", "a"))
        reqs = [module.Request("x" * 9, "a", 1), module.Request("x" * 3, "a", 1),
                module.Request("x" * 5, "b", 1), module.Request("x" * 2, "a", 1, gt_length=40),
                module.Request("x" * 7, "a", 1), module.Request("x" * 4, "a", 2),
                module.Request("x" * 6, "a", 1, gt_length=10), module.Request("x" * 1, "a", 1)]
        futs = [b.submit(r) for r in reqs]  # queued behind the blocked call
        release.set()
        wavs = [f.result(30) for f in futs]
        stats = b.stats()
    finally:
        b.close()
    return calls, [w.tolist() for w in wavs], {k: stats[k] for k in (
        "requests", "completed", "failed", "engine_calls", "batched_requests")}


def test_batcher_groups_and_chunks_as_jax():
    calls, wavs, stats = _engine_calls(batcher)
    assert (calls, wavs, stats) == _engine_calls(j_batcher)
    assert stats["engine_calls"] == len(calls) > 3 and stats["failed"] == 0


def test_server_end_to_end(int8_engine, greedy, monkeypatch):
    engine = int8_engine
    server = TTSServer(engine, max_batch=4, max_wait_ms=50).start()
    base = f"http://{server.host}:{server.port}"

    def post(path, body):
        req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.headers["Content-Type"], r.read()

    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True, "speakers": ["p"]}
        kind, data = post("/synthesize", {"text": "hello", "speaker": "p", "seed": 2,
                                          "gt_length": 8})
        sr, pcm = wavfile.read(io.BytesIO(data))
        assert kind == "audio/wav" and sr == engine.sample_rate and pcm.dtype == np.int16
        assert pcm.shape == (8 * engine.hop_length,)
        want = engine.synthesize(["hello"], "p", seed=2, gt_lengths=[8])[0]
        np.testing.assert_array_equal(pcm, (np.clip(want, -1, 1) * 32767).astype(np.int16))

        _, data = post("/synthesize", {"text": "One. Two two. Three three.", "speaker": "p",
                                       "long": True, "max_chunk_chars": 10, "gap_ms": 1.0})
        _, pcm = wavfile.read(io.BytesIO(data))
        parts = engine.synthesize(chunking.split_text("One. Two two. Three three.", 10), "p")
        assert len(parts) == 4  # "Three three." is split inside the sentence
        assert pcm.shape == (sum(len(w) for w in parts) + (len(parts) - 1) * 16,)

        for path, body, code in (
                ("/synthesize", {"text": "hi", "speaker": "nobody"}, 400),
                ("/synthesize", {"text": "hi"}, 400),
                ("/synthesize", {"text": "a b", "speaker": "p", "long": True, "gt_length": 5}, 400),
                ("/speakers", {"name": "q", "pcm_b64": "", "sample_rate": 16000}, 400),
                ("/speakers", {"name": "q", "sample_rate": 16000}, 400),
                ("/nowhere", {}, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(path, body)
            assert e.value.code == code

        # a speaker registered from a 24 kHz wav over HTTP, then used
        wav = (0.1 * np.random.default_rng(5).standard_normal(7200)).astype("<f4")
        pcm_b64 = base64.b64encode(wav.tobytes()).decode()
        _, data = post("/speakers", {"name": "q", "pcm_b64": pcm_b64, "sample_rate": 24000})
        assert json.loads(data) == {"ok": True} and engine.speakers() == ("p", "q")
        kind, data = post("/synthesize", {"text": "hi", "speaker": "q", "gt_length": 6})
        sr, pcm = wavfile.read(io.BytesIO(data))
        assert kind == "audio/wav" and pcm.shape == (6 * engine.hop_length,)
        # an engine without a semantic tokenizer answers 400, naming the way out
        monkeypatch.setattr(engine, "tokenizer", AudioTokenizer(engine.tokenizer.codec, None))
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/speakers", {"name": "r", "pcm_b64": pcm_b64, "sample_rate": 24000})
        assert e.value.code == 400
        assert "register_speaker_codes" in json.loads(e.value.read())["error"]
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["completed"] == 2 + len(parts) and stats["failed"] == 0
    finally:
        server.shutdown()
