"""Offline preprocessing in the port against the JAX package: the copied
data modules (text normalization, manifests, the native prefetcher, the HF
datasets wrappers, ``shard_for_process``, ``load_audio_segments``,
``collate_dump_batch``), the k-means fit, and the ``hubert_kmeans`` and
``dump_tokens`` command lines.

The copies are pinned by their source (the package name swapped) and by
their outputs on seeded LibriSpeech, LibriLight and LibriHeavy layouts of
FLAC files. The k-means fit: the JAX package's picks (``jax.random`` inside
``kmeans``, drawn here the same way) injected into the port; centers and
inertia to atol/rtol 1e-5 (f32, the same Lloyd steps in another summation
order) on seeded blobs, and exactly on integer points with repeated rows,
where most clusters go empty and are re-seeded (every sum is exact there).
``dump_tokens``: the port's CLI and the JAX CLI on the same tiny codec and
HuBERT (f32, CPU) write the same shards: ids, texts and codes equal, with
tests/test_torch_tokenizer.py's argmin-gap guard on each batch.
"""

import gzip
import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.data import collators as j_collators
from edm_tts_tpu.data import hf_datasets as j_hf_datasets
from edm_tts_tpu.data import manifests as j_manifests
from edm_tts_tpu.data import native_prefetch as j_native_prefetch
from edm_tts_tpu.data import pipeline as j_pipeline
from edm_tts_tpu.data import text_norm as j_text_norm
from edm_tts_tpu.models.tokenizer import AudioTokenizer as JAudioTokenizer
from edm_tts_tpu.ops.kmeans import kmeans as j_kmeans
from edm_tts_tpu.utils import hub as j_hub
from edm_tts_tpu_torch import dump_tokens, hubert_kmeans
from edm_tts_tpu_torch.data import collators, hf_datasets, manifests, native_prefetch, pipeline
from edm_tts_tpu_torch.data import text_norm
from edm_tts_tpu_torch.data.token_shards import iter_token_shards
from edm_tts_tpu_torch.models.tokenizer import AudioTokenizer
from edm_tts_tpu_torch.ops.kmeans import kmeans
from edm_tts_tpu_torch.utils import hub
from flac_encoder import encode_flac
from test_torch_tokenizer import _codes_margin
from torch_model_dirs import argv, tool
from torch_port_parity import TINY_HUBERT, codec_pair, hubert_pair

KMEANS_TOL = dict(atol=1e-5, rtol=1e-5)


def _src(obj) -> str:
    return inspect.getsource(obj).replace("edm_tts_tpu_torch.", "edm_tts_tpu.")


COPIES = [
    (text_norm, j_text_norm, ("normalize_text", "clean_text", "text_to_bytes")),
    (manifests, j_manifests, ("librispeech_manifest", "librilight_manifest",
                              "libriheavy_manifest", "chunk_jsonl_gz")),
    (native_prefetch, j_native_prefetch, ("_bind", "AudioPrefetcher", "prefetch_audio_windows",
                                          "prefetch_manifest")),
    (hf_datasets, j_hf_datasets, ("load_dataset",)),
    (pipeline, j_pipeline, ("shard_for_process", "load_audio_segments")),
    (collators, j_collators, ("collate_dump_batch",)),
]


@pytest.mark.parametrize("port,jax_mod,names", COPIES, ids=[c[0].__name__ for c in COPIES])
def test_copies_equal_jax(port, jax_mod, names):
    for name in names:
        assert _src(getattr(port, name)) == inspect.getsource(getattr(jax_mod, name)), name
    if port is text_norm:
        assert (port._KEEP, port._PUNC_TABLE) == (jax_mod._KEEP, jax_mod._PUNC_TABLE)
    if port is manifests:
        assert (port.LIBRISPEECH_SPLITS, port.LIBRILIGHT_SUBSETS) == (
            jax_mod.LIBRISPEECH_SPLITS, jax_mod.LIBRILIGHT_SUBSETS)


def _tone(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A seeded int16-range waveform: a tone in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return np.round(np.clip(wav, -1, 1) * 32767).astype(np.int64)


def _flac(path: Path, seconds: float, sr: int, seed: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_flac(_tone(seconds, sr, seed)[None], sample_rate=sr))


def librispeech(root: Path, seconds=(0.9, 0.55, 1.3), split="train-clean-100") -> None:
    """``root/LibriSpeech/<split>/19/198/19-198-000i.flac`` + transcripts."""
    folder = root / "LibriSpeech" / split / "19" / "198"
    lines = []
    for i, s in enumerate(seconds):
        _flac(folder / f"19-198-{i:04d}.flac", s, 16000, i)
        lines.append(f"19-198-{i:04d} THE ’QUICK’ FOX NUMBER {i}, JUMPS！")
    (folder / "19-198.trans.txt").write_text("\n".join(lines) + "\n")


def librilight(root: Path) -> None:
    """Two speakers' books at 16 kHz (windows of 1 s, a padded last one);
    seeds whose tiny-model distances leave every argmin its gap."""
    _flac(root / "small" / "100" / "book" / "a.flac", 2.3, 16000, 2)
    _flac(root / "small" / "200" / "book" / "b.flac", 1.0, 16000, 3)


def libriheavy(root: Path) -> None:
    """One recording at 24 kHz and a chunked cut manifest over it."""
    _flac(root / "heavy" / "300" / "c.flac", 2.0, 24000, 6)
    (root / "libriheavy" / "small").mkdir(parents=True)
    cuts = [{"id": f"cut{i}", "start": 0.4 * i + 0.0007, "duration": 0.7333,
             "recording": {"id": "heavy/300/c", "sampling_rate": 24000},
             "supervisions": [{"custom": {"texts": [f"“Hello,” said number {i}。"]}}]}
            for i in range(3)]
    with gzip.open(root / "libriheavy" / "small" / "cuts.00000.jsonl.gz", "wt") as f:
        f.write("\n".join(json.dumps(c) for c in cuts) + "\n")


def test_manifests_prefetch_and_segments_equal_jax(tmp_path):
    librispeech(tmp_path)
    librilight(tmp_path)
    libriheavy(tmp_path)
    pairs = [
        (manifests.librispeech_manifest(str(tmp_path), "train-clean-100"),
         j_manifests.librispeech_manifest(str(tmp_path), "train-clean-100")),
        (manifests.librilight_manifest(str(tmp_path), "small", segment_seconds=1.0),
         j_manifests.librilight_manifest(str(tmp_path), "small", segment_seconds=1.0)),
        (manifests.libriheavy_manifest(str(tmp_path), "small"),
         j_manifests.libriheavy_manifest(str(tmp_path), "small")),
    ]
    for mine, theirs in pairs:
        mine, theirs = list(mine), list(theirs)
        assert mine == theirs and len(mine) >= 3
        assert list(pipeline.shard_for_process(mine, 1, 2)) == list(
            j_pipeline.shard_for_process(theirs, 1, 2)) == mine[1::2]
        fetched = list(native_prefetch.prefetch_manifest(iter(mine), n_threads=2, max_inflight=2))
        j_fetched = list(j_native_prefetch.prefetch_manifest(iter(theirs), n_threads=2))
        for ex, jex in zip(fetched, j_fetched):
            np.testing.assert_array_equal(ex.pop("_audio"), jex.pop("_audio"))
            assert ex == jex
        for ex in mine:
            seg = list(pipeline.load_audio_segments(ex, 16000, 0.25))
            j_seg = list(j_pipeline.load_audio_segments(ex, 16000, 0.25))
            assert [s["id"] for s in seg] == [s["id"] for s in j_seg] and seg
            for s, js in zip(seg, j_seg):  # 24 kHz goes through each package's resampler
                np.testing.assert_allclose(s["audio"], js["audio"], atol=1e-5)
    first = next(manifests.librispeech_manifest(str(tmp_path), "train-clean-100"))
    assert (first["transcription"], first["no_punc_transcription"]) == (
        "THE 'QUICK' FOX NUMBER 0, JUMPS!", "THE 'QUICK' FOX NUMBER 0 JUMPS")
    out = tmp_path / "chunks"
    assert manifests.chunk_jsonl_gz(str(tmp_path / "libriheavy" / "small" / "cuts.00000.jsonl.gz"),
                                    str(out), lines_per_chunk=2) == 2


def _jax_picks(n: int, k: int, niter: int, nredo: int, seed: int):
    """The indices JAX ``kmeans`` draws: per run, the initial rows and each
    iteration's re-seed rows."""
    key = jax.random.PRNGKey(seed)
    init, reseed = [], []
    for _ in range(nredo):
        key, sub = jax.random.split(key)
        init.append(np.asarray(jax.random.choice(sub, n, (k,), replace=False)))
        kk, rows = sub, []
        for _ in range(niter):
            kk, s2 = jax.random.split(kk)
            rows.append(np.asarray(jax.random.choice(s2, n, (k,))))
        reseed.append(np.stack(rows))
    return np.stack(init), np.stack(reseed)


@pytest.mark.parametrize("data", ["blobs", "repeated integer points"])
def test_kmeans_fit_matches_jax_with_its_picks(data):
    rng = np.random.default_rng(11)
    if data == "blobs":
        centers = rng.standard_normal((6, 8)) * 6.0
        x = (centers[rng.integers(0, 6, 300)] + rng.standard_normal((300, 8)) * 0.7)
        k, exact = 10, False
    else:
        x = rng.integers(-5, 6, (5, 4))[rng.integers(0, 5, 240)]
        k, exact = 9, True
    x = x.astype(np.float32)
    niter, nredo, seed = 6, 3, 42
    init, reseed = _jax_picks(len(x), k, niter, nredo, seed)
    j_centers, j_inertia = j_kmeans(jnp.asarray(x), k, niter=niter, nredo=nredo, seed=seed)
    history = []
    got, inertia = kmeans(torch.from_numpy(x), k, niter=niter, nredo=nredo, seed=seed,
                          init_indices=init, reseed_indices=reseed, history=history)
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_centers))
        assert float(inertia) == float(j_inertia)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(j_centers), **KMEANS_TOL)
        np.testing.assert_allclose(float(inertia), float(j_inertia), **KMEANS_TOL)
    assert len(history) == nredo and all(len(h) == niter for h in history)
    for h in history:  # Lloyd's inertia never rises
        assert all(b <= a * (1 + 1e-6) for a, b in zip(h, h[1:])), h
    # the generator's own picks: a valid fit, reproducible from the seed
    again = [kmeans(torch.from_numpy(x), k, niter=niter, nredo=nredo, seed=seed)
             for _ in range(2)]
    assert torch.equal(again[0][0], again[1][0]) and again[0][0].shape == (k, x.shape[1])


def test_hubert_kmeans_writes_centroids_that_hub_loads(tmp_path):
    _, _, sem = hubert_pair(seed=0, output_layer=2)
    hub.save_hubert_hf(str(tmp_path / "hf"), sem, "centroids.npy")
    librispeech(tmp_path / "data")
    out = tmp_path / "out"
    out.mkdir()
    torch.save(torch.zeros(3, 16), out / "centroids.pt")  # a stale fit, which must go
    k, per, niter, nredo = 4, 6, 3, 2
    hubert_kmeans.main(["--data_dir", str(tmp_path / "data"), "--hubert_model",
                        str(tmp_path / "hf"), "--output", str(out), "--k", str(k),
                        "--frames_per_cluster", str(per), "--niter", str(niter), "--nredo",
                        str(nredo), "--seed", "3", "--output_layer", "18", "--max_seconds", "1.0",
                        "--device", "cpu"])
    assert not (out / "centroids.pt").exists()
    loaded = hub.load_semantic_tokenizer(str(out), output_layer=2, device="cpu")
    # the same fit from the features of the same utterances through the
    # HuBERT of the directory the CLI read
    feats = []
    sem = hub.load_hubert(str(tmp_path / "hf"), 2, k, device="cpu")
    with torch.no_grad():
        for ex in manifests.librispeech_manifest(str(tmp_path / "data"), "train-clean-100"):
            audio = next(pipeline.load_audio_segments(ex, 16000, None))["audio"][:16000]
            feats.append(sem.hidden_states(torch.from_numpy(audio)[None])[0])
    x = torch.cat(feats)[:k * per]
    assert x.shape == (k * per, TINY_HUBERT["hidden_size"])
    want, _ = kmeans(x, k, niter=niter, nredo=nredo, seed=3)
    torch.testing.assert_close(loaded.cluster_centers, want, rtol=0, atol=0)
    for name, p in sem.hubert.state_dict().items():  # the weights copied as they were
        torch.testing.assert_close(loaded.hubert.state_dict()[name], p, rtol=0, atol=0)


@pytest.mark.parametrize("dataset", ["librilight", "librispeech"])
def test_dump_tokens_shards_equal_jax_cli(tmp_path, dataset):
    jcodec, variables, codec = codec_pair(seed=0)
    jsem, sem_params, sem = hubert_pair(seed=0, output_layer=2)
    j_hub.save_codec(str(tmp_path / "jax_codec"), jcodec, variables)
    j_hub.save_hubert(str(tmp_path / "jax_hubert"), jsem.config, sem_params["hubert"],
                      sem.cluster_centers.numpy())
    hub.save_reference(str(tmp_path / "codec"), codec)
    hub.save_hubert_hf(str(tmp_path / "hubert"), sem, "centroids.npy")
    data = tmp_path / "data"
    if dataset == "librilight":
        librilight(data)
        subset, extra = "small", ["--segment_seconds", "1.0"]
    else:
        librispeech(data)
        subset, extra = "train-clean-100", []
    common = ["--dataset", dataset, "--data_dir", str(data), "--subset", subset,
              "--batch_size", "2", "--dtype", "float32", "--items_per_shard", "2", *extra]
    dump_tokens.main([*common, "--output_dir", str(tmp_path / "port"), "--codec_model",
                      str(tmp_path / "codec"), "--hubert_model", str(tmp_path / "hubert"),
                      "--device", "cpu"])
    with argv("dump_tokens.py", *common, "--output_dir", str(tmp_path / "jax"), "--codec_model",
              str(tmp_path / "jax_codec"), "--hubert_model", str(tmp_path / "jax_hubert")):
        tool("dump_tokens").main()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    mine = list(iter_token_shards(str(tmp_path / "port")))
    theirs = list(iter_token_shards(str(tmp_path / "jax")))
    assert len(mine) == len(theirs) == (4 if dataset == "librilight" else 3)
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                assert a[key] == b[key], key
        assert a["acoustic_tokens"].shape[1] == a["semantic_tokens"].shape[0] > 0
    # the argmin-gap guard over the batches the CLIs made
    tok = AudioTokenizer(codec, sem)
    jtok = JAudioTokenizer(jcodec, jsem)
    windows = list(manifests.librilight_manifest(str(data), subset, segment_seconds=1.0)
                   if dataset == "librilight" else
                   manifests.librispeech_manifest(str(data), subset))
    for i in range(0, len(windows), 2):
        batch = collators.collate_dump_batch(windows[i:i + 2], tok)
        _codes_margin(tok, jtok, variables, sem_params, batch["normalized_audio"],
                      batch["padded_audio"], batch["attention_mask"])
