"""The port's model directories (``utils.hub``, ``utils.safetensors``) and
audio files (``data.audio_io``, ``data.native_flac``) against the JAX
package's.

The same seeded tiny weights are written as the JAX package's own
directories, as the reference format by ``utility_scripts/export_torch.py``,
as the port's ``pytorch_model.bin`` and as an HF HuBERT directory
(tests/torch_model_dirs.py). The port's loaders read them to the same state
dict (exact) and the same logits and decodes as the JAX package's loaders
from their own directories (atol/rtol 1e-4, the parity tests' tolerance);
the HuBERT directory gives the JAX tokenizer's codes token for token, with
its centroids in each file format. The safetensors reader and writer equal
``safetensors.numpy``'s, the HF config translation equals
``utility_scripts/convert_hubert.py``'s, and the audio readers equal the
JAX package's, all exactly.
"""

import ast
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import edm_tts_tpu.utils.hub as j_hub
from edm_tts_tpu.data import audio_io as j_audio_io
from edm_tts_tpu.models.hubert import HubertConfig as JHubertConfig
from edm_tts_tpu.models.s2a import InjectionConformer as JInjectionConformer
from edm_tts_tpu.models.t2s import TextToSemantic as JTextToSemantic
from edm_tts_tpu_torch.data import audio_io
from edm_tts_tpu_torch.utils import hub, safetensors
from flac_encoder import encode_flac
from torch_model_dirs import CENTROID_FILES, ROOT, model_dirs, prompt_audio, tool
from torch_port_parity import TINY_HUBERT, TINY_S2A, TINY_T2S

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return model_dirs(tmp_path_factory.mktemp("dirs"), TINY_T2S, TINY_S2A)


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_same_state(a: dict, b: dict, **tol) -> None:
    """Equal state dicts: exactly, or within ``tol`` (HuBERT's positional
    conv goes through a weight-norm fold, ~1e-7 off)."""
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], **(tol or dict(rtol=0, atol=0)), msg=k)


FOLD_TOL = dict(rtol=1e-6, atol=1e-7)


# -- safetensors ------------------------------------------------------------
ARRAYS = {
    "F32": np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32),
    "F16": np.random.default_rng(1).standard_normal((2, 5)).astype(np.float16),
    "I64": np.arange(-6, 6).reshape(3, 4),
    "I32": np.arange(7, dtype=np.int32) - 3,
    "I8": np.arange(-128, 128, 17, dtype=np.int8),
    "BOOL": np.array([True, False, True]),
    "F32 0-d": np.array(2.5, np.float32),
}


@pytest.mark.parametrize("name", list(ARRAYS) + ["BF16"])
def test_safetensors_equal_the_safetensors_package(tmp_path, name):
    from safetensors.numpy import load_file as st_load
    from safetensors.numpy import save_file as st_save
    from safetensors.torch import load_file as st_load_torch
    from safetensors.torch import save_file as st_save_torch

    if name == "BF16":
        t = torch.randn(4, 3).bfloat16()
        safetensors.save_file({"x": t, "y": ARRAYS["F32"]}, str(tmp_path / "mine"))
        assert torch.equal(st_load_torch(str(tmp_path / "mine"))["x"], t)
        st_save_torch({"x": t}, str(tmp_path / "theirs"))
        back = safetensors.load_file(str(tmp_path / "theirs"))["x"]
        assert back.dtype == torch.bfloat16 and torch.equal(back, t)
        return
    arr = ARRAYS[name]
    safetensors.save_file({"x": arr, "other": ARRAYS["I8"]}, str(tmp_path / "mine"),
                          metadata={"format": "np"})
    theirs = st_load(str(tmp_path / "mine"))
    assert theirs["x"].dtype == arr.dtype and theirs["x"].shape == arr.shape
    np.testing.assert_array_equal(theirs["x"], arr)
    st_save({"x": arr, "other": ARRAYS["I8"]}, str(tmp_path / "theirs"))
    mine = safetensors.load_file(str(tmp_path / "theirs"))
    assert mine["x"].dtype == arr.dtype and mine["x"].shape == arr.shape
    np.testing.assert_array_equal(mine["x"], arr)
    np.testing.assert_array_equal(mine["other"], ARRAYS["I8"])


# -- codec, t2s, s2a --------------------------------------------------------
def test_codec_dir_loads_as_jax(built):
    """The reference codec directory loads to the weights of the port's
    codec that the parity tests hold against JAX (its encode against the
    JAX loader's: test_hubert_dir_tokenizes_as_jax)."""
    codec = hub.load_codec(built["dirs"]["ref_codec"], device="cpu")
    _assert_same_state(_state(codec), _state(built["s2a"][2].acoustic_model))
    assert codec.config == built["s2a"][2].acoustic_model.config


def test_t2s_dirs_load_as_jax(built):
    dirs = built["dirs"]
    ref_fmt = hub.load_t2s(dirs["ref_t2s"], device="cpu")
    port_fmt = hub.load_t2s(dirs["port_t2s"], device="cpu")
    _assert_same_state(_state(ref_fmt), _state(port_fmt))
    _assert_same_state(_state(ref_fmt), _state(built["t2s"][2]))
    jmodel, jvars = j_hub.load_t2s(dirs["jax_t2s"])
    tokens = np.random.default_rng(0).integers(5, 269, (2, 24))
    attention = np.ones((2, 24), bool)
    j_emb = jmodel.apply(jvars, jnp.asarray(tokens, jnp.int32), method=JTextToSemantic.embed)
    j_logits = jmodel.apply(jvars, j_emb, jnp.asarray(attention), conv_pad_mask=jnp.asarray(attention),
                            method=JTextToSemantic.embeddings_to_logits)
    for model in (ref_fmt, port_fmt):
        with torch.no_grad():
            att = torch.from_numpy(attention)
            logits = model.embeddings_to_logits(model.embed(torch.from_numpy(tokens)), att,
                                                conv_pad_mask=att)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)


def test_s2a_dirs_load_as_jax(built, tmp_path, monkeypatch):
    dirs = built["dirs"]
    ref_fmt = hub.load_s2a(dirs["ref_s2a"], device="cpu")
    port_fmt = hub.load_s2a(dirs["port_s2a"], device="cpu")
    want = _state(built["s2a"][2])
    _assert_same_state(_state(ref_fmt), want)
    _assert_same_state(_state(port_fmt), want)
    assert ref_fmt.cfg == port_fmt.cfg == built["s2a"][2].cfg
    jmodel, jvars = j_hub.load_s2a(dirs["jax_s2a"])
    x = np.random.default_rng(1).standard_normal((2, 13, TINY_S2A["hidden_size"])).astype(np.float32)
    valid = np.arange(13)[None, :] < np.array([[9], [13]])
    ref = jmodel.apply(jvars, jnp.asarray(x), jnp.asarray(valid),
                       method=JInjectionConformer.forward_first_level)
    with torch.no_grad():
        out = ref_fmt.forward_first_level(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], **TOL)

    # acoustic_model_path relative to the s2a directory, and the codec's
    # weights taken from that directory when the s2a file holds none
    moved = tmp_path / "s2a"
    shutil.copytree(dirs["ref_s2a"], moved)
    cfg = json.loads((moved / "config.json").read_text())
    cfg["acoustic_model_path"] = "acoustic_model"
    (moved / "config.json").write_text(json.dumps(cfg))
    sd = safetensors.load_file(str(moved / "model.safetensors"))
    safetensors.save_file({k: v for k, v in sd.items() if not k.startswith("acoustic_model.")},
                          str(moved / "model.safetensors"))
    monkeypatch.chdir(tmp_path.parent)
    _assert_same_state(_state(hub.load_s2a(str(moved), device="cpu")), want)
    cfg["acoustic_model_path"] = str(tmp_path / "missing")
    (moved / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match="acoustic_model_path"):
        hub.load_s2a(str(moved), device="cpu")


def test_quantized_loads_equal_quantized_models(built):
    from edm_tts_tpu_torch.models import quantize as quantization
    from edm_tts_tpu_torch.utils.hub import load_t2s

    dirs = built["dirs"]
    q = load_t2s(dirs["ref_t2s"], device="cpu", quantize="int8")
    want = quantization.quantize_t2s(hub.load_t2s(dirs["port_t2s"], device="cpu"), "int8")
    _assert_same_state(_state(q), _state(want))
    with pytest.raises(ValueError, match="quantize"):
        load_t2s(dirs["ref_t2s"], device="cpu", quantize="int4")


# -- HuBERT and the tokenizer -----------------------------------------------
def test_hf_config_translation_equals_convert_hubert():
    """The port's table against the one in convert_hubert.py's main (taken
    from its source), on a full HF config and on one with only the required
    keys (HF's defaults)."""
    tree = ast.parse((ROOT / "utility_scripts" / "convert_hubert.py").read_text())
    call = next(node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call) and getattr(node.value.func, "id", "") == "HubertConfig")
    expr = compile(ast.Expression(call), "convert_hubert.py", "eval")
    full = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_HUBERT.items()}
    full.update(conv_bias=False, feat_extract_norm="group", layer_norm_eps=1e-6,
                do_stable_layer_norm=False)
    required = {k: full[k] for k in ("conv_dim", "conv_kernel", "conv_stride", "hidden_size",
                                     "num_hidden_layers", "num_attention_heads",
                                     "intermediate_size")}
    for hf in (full, required):
        theirs = dataclasses.asdict(eval(expr, {"HubertConfig": JHubertConfig, "hf_cfg": hf}))
        mine = dataclasses.asdict(hub.hubert_config_from_hf(hf))
        assert mine == theirs


@pytest.mark.parametrize("centroids", CENTROID_FILES)
def test_hubert_dir_tokenizes_as_jax(built, centroids, tmp_path):
    dirs = built["dirs"]
    hf = tmp_path / "hubert"
    shutil.copytree(dirs["hf_hubert"], hf)
    for name in CENTROID_FILES:  # leave only the file under test
        if name != centroids:
            os.remove(hf / name)
    kw = dict(device="cpu")
    if centroids in hub.CENTROID_NAMES:
        sem = hub.load_semantic_tokenizer(str(hf), **kw)
    else:
        with pytest.raises(FileNotFoundError, match="centroids"):
            hub.load_semantic_tokenizer(str(hf), **kw)
        sem = hub.load_semantic_tokenizer(str(hf), centroids=str(hf / centroids), **kw)
    _assert_same_state(_state(sem), _state(built["hubert"][2]), **FOLD_TOL)
    tokenizer = hub.AudioTokenizer(hub.load_codec(dirs["ref_codec"], **kw), sem)
    jtok, jcodec_params, jsem_params = j_hub.build_audio_tokenizer(dirs["jax_codec"],
                                                                   dirs["jax_hubert"])
    wav = prompt_audio(0.4, 16000, seed=3)[None]
    ref = jtok.compute_codes(jcodec_params, jsem_params, wav)
    out = tokenizer.compute_codes(wav)
    np.testing.assert_array_equal(out["acoustic_codes"].numpy(), np.asarray(ref["acoustic_codes"]))
    np.testing.assert_array_equal(out["semantic_codes"].numpy(), np.asarray(ref["semantic_codes"]))


def test_hubert_writer_reads_back_in_both_packages(built, tmp_path):
    """``save_hubert_hf`` writes a directory that convert_hubert.py and the
    port's loader read to the same model."""
    from torch_model_dirs import argv

    sem = built["hubert"][2]
    hub.save_hubert_hf(str(tmp_path / "hf"), sem, centroids="centroids.npz")
    back = hub.load_semantic_tokenizer(str(tmp_path / "hf"), output_layer=sem.output_layer,
                                       device="cpu")
    _assert_same_state(_state(back), _state(sem), **FOLD_TOL)
    with argv("convert_hubert.py", "--hf_dir", str(tmp_path / "hf"), "--output",
              str(tmp_path / "jax"), "--kmeans", str(tmp_path / "hf" / "centroids.npz")):
        tool("convert_hubert").main()
    _, params = j_hub.load_semantic_tokenizer(str(tmp_path / "jax"))
    _, want = j_hub.load_semantic_tokenizer(built["dirs"]["jax_hubert"])
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_compute_codes_from_file_equals_jax(built, tmp_path):
    dirs = built["dirs"]
    wav = prompt_audio(0.5, 24000, seed=4)
    path = tmp_path / "p.flac"
    path.write_bytes(encode_flac(np.round(wav * 32767).astype(np.int64)[None], 24000))
    tokenizer = hub.build_audio_tokenizer(dirs["ref_codec"], dirs["hf_hubert"], device="cpu")
    jtok, jcodec_params, jsem_params = j_hub.build_audio_tokenizer(dirs["jax_codec"],
                                                                   dirs["jax_hubert"])
    out = tokenizer.compute_codes_from_file(str(path), 1200, 9000)
    ref = jtok.compute_codes_from_file(jcodec_params, jsem_params, str(path), 1200, 9000)
    for key in ("acoustic_codes", "semantic_codes"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


# -- audio files ------------------------------------------------------------
def test_audio_io_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, (2, 3001))
    files = {
        "int16.wav": (np.round(x * 32767).astype(np.int16).T, 16000),
        "int32.wav": (np.round(x * 2 ** 31 * 0.9).astype(np.int32).T, 24000),
        "float.wav": (x.astype(np.float32).T, 22050),
        "mono.wav": (np.round(x[0] * 32767).astype(np.int16), 16000),
    }
    for name, (data, sr) in files.items():
        wavfile.write(tmp_path / name, sr, data)
    (tmp_path / "a.flac").write_bytes(encode_flac(np.round(x * 32767).astype(np.int64), 24000,
                                                  seek_every_frames=1))
    for name in ("int16.wav", "mono.wav", "a.flac"):  # the wave module reads PCM16 headers
        path = str(tmp_path / name)
        assert (dataclasses.astuple(audio_io.audio_info(path))
                == dataclasses.astuple(j_audio_io.audio_info(path)))
    for name in [*files, "a.flac"]:
        path = str(tmp_path / name)
        for offset, frames in ((0, -1), (700, 1500), (2990, 100)):
            mine, sr = audio_io.load_audio(path, offset, frames)
            theirs, jsr = j_audio_io.load_audio(path, offset, frames)
            assert sr == jsr and mine.dtype == theirs.dtype == np.float32
            np.testing.assert_array_equal(mine, theirs)
    with pytest.raises(ValueError, match="unsupported"):
        audio_io.load_audio(str(tmp_path / "a.mp3"))
    audio_io.save_wav(str(tmp_path / "mine.wav"), x.astype(np.float32), 16000)
    j_audio_io.save_wav(str(tmp_path / "theirs.wav"), x.astype(np.float32), 16000)
    assert (tmp_path / "mine.wav").read_bytes() == (tmp_path / "theirs.wav").read_bytes()
