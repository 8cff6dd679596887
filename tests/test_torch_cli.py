"""The port's command-line entry points (``python -m
edm_tts_tpu_torch.inference`` and ``python -m edm_tts_tpu_torch.serve``)
against the root ``inference.py`` and ``serve.py`` of the JAX package.

Both read the same seeded tiny weights from their own model directories
(tests/torch_model_dirs.py: the JAX package's orbax directories for the
root CLIs; the reference ``model.safetensors`` format and an HF HuBERT
directory for the port), f32 on the CPU, at temperature 0 with both
packages' samplers switched to greedy inside the test (the port cannot
reproduce ``jax.random``'s streams). The prompt is a 24 kHz FLAC file, so
both resample it. The written WAVs have the same lengths, and their samples
agree within test_torch_pipeline.py's atol/rtol 1e-4 plus one int16 step
(both CLIs write 16-bit PCM). The widths are QUANT_T2S / QUANT_S2A, so that
``--quantize int8`` has sites on both sides of the shape gate.
"""

import functools
import io
import json
import sys
import urllib.request
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

import edm_tts_tpu.models.s2a as j_s2a_pkg
import edm_tts_tpu.models.t2s as j_t2s_pkg
import edm_tts_tpu.pipeline as j_pipeline
import edm_tts_tpu_torch.inference as inference
import edm_tts_tpu_torch.serving.engine as engine_mod
from edm_tts_tpu_torch import serve
from flac_encoder import encode_flac
from torch_model_dirs import ROOT, model_dirs, prompt_audio
from torch_port_parity import QUANT_S2A, QUANT_T2S

PCM_STEP = 1 / 32767
TOL = dict(atol=1e-4 + PCM_STEP, rtol=1e-4)
SAMPLING = ["--pred_iters", "3", "--s2a_steps", "3", "--temperature", "0",
            "--max_speech_len", "16", "--length_bucket", "8", "--dtype", "float32"]
TEXTS = ["hi", "hello there", "tiny tts!"]


def _root_module(name: str):
    sys.path.insert(0, str(ROOT))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = model_dirs(root, QUANT_T2S, QUANT_S2A)
    wav = prompt_audio(0.3, 24000, seed=5)
    prompt = root / "prompt.flac"
    prompt.write_bytes(encode_flac(np.round(wav * 32767).astype(np.int64)[None], 24000))
    (root / "texts.txt").write_text("\n".join(TEXTS) + "\n")
    return {**out, "prompt": str(prompt), "texts": str(root / "texts.txt")}


@pytest.fixture
def greedy(monkeypatch):
    """Every sampler the four entry points reach takes the argmax."""
    for module in (j_t2s_pkg, j_pipeline):
        monkeypatch.setattr(module, "t2s_sample",
                            functools.partial(j_t2s_pkg.t2s_sample, greedy=True))
    for module in (j_s2a_pkg, j_pipeline):
        monkeypatch.setattr(module, "s2a_sample",
                            functools.partial(j_s2a_pkg.s2a_sample, greedy=True))
    for module in (inference, engine_mod):
        monkeypatch.setattr(module, "t2s_sample",
                            functools.partial(module.t2s_sample, greedy=True))
        monkeypatch.setattr(module, "s2a_sample",
                            functools.partial(module.s2a_sample, greedy=True))
    monkeypatch.setattr(inference, "e2e_synthesize",
                        functools.partial(inference.e2e_synthesize, greedy=True))


def _model_args(dirs: dict, kind: str) -> list[str]:
    if kind == "jax":
        return ["--codec_model", dirs["jax_codec"], "--t2s_model", dirs["jax_t2s"],
                "--s2a_model", dirs["jax_s2a"], "--hubert_model", dirs["jax_hubert"]]
    return ["--codec_model", dirs["ref_codec"], "--t2s_model", dirs["ref_t2s"],
            "--s2a_model", dirs["ref_s2a"], "--hubert_model", dirs["hf_hubert"],
            "--device", "cpu"]


def _read(path) -> tuple[int, np.ndarray]:
    sr, pcm = wavfile.read(path)
    assert pcm.dtype == np.int16
    return sr, pcm.astype(np.float32) / 32767


CASES = {
    "single with gt_length": ["-t", "hello world", "--gt_length", "12"],
    "text_file, int8": ["--text_file", None, "--quantize", "int8"],
    "long in groups of 2": ["-t", "One. Two two. Three three. Four.", "--long",
                            "--long_batch", "2", "--max_chunk_chars", "10"],
    "one_shot": ["-t", "hello there", "--one_shot", "--gt_length", "16"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_inference_cli_writes_the_root_cli_wavs(built, greedy, tmp_path, monkeypatch, case):
    args = [built["texts"] if a is None else a for a in CASES[case]]
    outputs = {}
    for kind in ("jax", "port"):
        out = tmp_path / kind / "out.wav"
        out.parent.mkdir()
        argv = ["-s", built["prompt"], "-o", str(out), *args, *SAMPLING,
                *_model_args(built["dirs"], kind)]
        if kind == "jax":
            monkeypatch.setattr(sys, "argv", ["inference.py", *argv])
            _root_module("inference").main()
        else:
            inference.main(argv)
        outputs[kind] = sorted(p.name for p in out.parent.iterdir())
    assert outputs["jax"] == outputs["port"]
    if "--text_file" in args:
        assert outputs["port"] == [f"out_{i}.wav" for i in range(len(TEXTS))]
    for name in outputs["port"]:
        sr, mine = _read(tmp_path / "port" / name)
        jsr, theirs = _read(tmp_path / "jax" / name)
        assert sr == jsr == 16000 and mine.shape == theirs.shape and mine.size > 0
        if "--gt_length" in args:
            assert mine.size == int(args[args.index("--gt_length") + 1]) * 320
        np.testing.assert_allclose(mine, theirs, **TOL)


def _post(base: str, path: str, body: dict) -> bytes:
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def test_serve_build_server_answers_as_the_root_one(built, greedy):
    common = dict(speaker=[f"p={built['prompt']}"], host="127.0.0.1", port=0, max_batch=4,
                  max_wait_ms=20.0, batch_lookahead=4, pred_iters=3, s2a_steps=3,
                  temperature=0.0, max_speech_len=16, dtype="float32", quantize="none",
                  quantize_t2s=None, quantize_s2a=None)
    dirs = built["dirs"]
    j_args = Namespace(codec_model=dirs["jax_codec"], t2s_model=dirs["jax_t2s"],
                       s2a_model=dirs["jax_s2a"], hubert_model=dirs["jax_hubert"], **common)
    args = serve.parser().parse_args(_model_args(dirs, "port"))
    for k, v in common.items():
        setattr(args, k, v)
    servers = [_root_module("serve").build_server(j_args).start(), serve.build_server(args).start()]
    try:
        assert [s.engine.speakers() for s in servers] == [("p",), ("p",)]
        mine_codes, their_codes = servers[1].engine.prompt("p"), servers[0].engine._speakers["p"]
        np.testing.assert_array_equal(mine_codes.acoustic_codes.numpy(),
                                      np.asarray(their_codes.acoustic_codes))
        wavs = []
        for s in servers:
            base = f"http://{s.host}:{s.port}"
            with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
                assert json.loads(r.read()) == {"ok": True, "speakers": ["p"]}
            data = _post(base, "/synthesize", {"text": "hello there", "speaker": "p", "seed": 1})
            wavs.append(_read(io.BytesIO(data)))
        (jsr, theirs), (sr, mine) = wavs
        assert sr == jsr and mine.shape == theirs.shape and mine.size > 0
        np.testing.assert_allclose(mine, theirs, **TOL)
    finally:
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("entry", ["inference", "serve"])
def test_device_cuda_without_a_card_exits_non_zero(built, entry, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(inference.torch.cuda, "is_available", lambda: False)
    dirs = built["dirs"]
    argv = _model_args(dirs, "port")[:-2] + ["--device", "cuda"]
    if entry == "inference":
        argv += ["-s", built["prompt"], "-t", "hi", "-o", str(tmp_path / "x.wav")]
    main = inference.main if entry == "inference" else serve.main
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.wav").exists()
