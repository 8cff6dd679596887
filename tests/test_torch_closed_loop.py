"""The port's closed-loop rehearsal (``edm_tts_tpu_torch.closed_loop``)
against the JAX package's ``scripts/closed_loop.py``, and the port's copy of
the FLAC writer against ``tests/flac_encoder.py``: cheap checks, no
training stage (tests/test_torch_closed_loop_run.py runs the loop, each
stage's command in the test's process); ``run_stage`` here runs real
subprocesses: a module of the port from the checkout, a skip and a failure.

The JAX script is imported as a module; only its ``make_tiny_hubert``
imports jax, and it is not called. Equality throughout: the same file tree,
transcripts and FLAC bytes for seed 0, the templates as strings, the FLAC
writer's bytes and source.
"""

import ast
import importlib.util
import inspect
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flac_encoder as test_flac
from edm_tts_tpu_torch import closed_loop
from edm_tts_tpu_torch.data import flac_encoder as port_flac

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_closed_loop",
                                                  ROOT / "scripts" / "closed_loop.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_make_dataset_writes_the_jax_scripts_tree(jax_script, tmp_path):
    jax_script.make_dataset(str(tmp_path / "jax"), n_speakers=2, n_utts=3)
    closed_loop.make_dataset(str(tmp_path / "port"), n_speakers=2, n_utts=3)
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(port_tree) == 2 * (3 + 1)  # FLACs and a transcript per speaker
    assert port_tree.keys() == jax_tree.keys()
    for name, data in jax_tree.items():
        assert port_tree[name] == data, name
    assert jax_script.WORDS == closed_loop.WORDS and jax_script.SR == closed_loop.SR


@pytest.mark.parametrize("name", ["CODEC_YAML", "T2S_YAML", "S2A_YAML"])
def test_recipe_templates_equal_the_jax_scripts(jax_script, name):
    assert getattr(closed_loop, name) == getattr(jax_script, name)


def test_tiny_hubert_has_the_jax_scripts_config(jax_script):
    """The same HubertConfig fields as the JAX script's ``make_tiny_hubert``
    (read from its source, which is not run: it imports jax)."""
    call = next(n for n in ast.walk(ast.parse(inspect.getsource(jax_script.make_tiny_hubert)))
                if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "HubertConfig")
    want = {kw.arg: eval(ast.unparse(kw.value)) for kw in call.keywords}  # literals
    cfg = closed_loop.make_tiny_hubert().config
    assert {k: getattr(cfg, k) for k in want} == want


def test_cli_passes_the_jax_scripts_recipes_and_defaults(jax_script, monkeypatch, tmp_path):
    # the JAX script's sizes that its main does not pass are run's defaults,
    # and those that no caller changes are the module's constants
    defaults = {k: p.default for k, p in inspect.signature(closed_loop.run).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults == dict(frames_per_cluster=50, device="cuda", n_speakers=3, n_utts=20,
                            pred_iters=4, s2a_steps=4)
    src = inspect.getsource(jax_script.main)
    for flag, value in [("--frames_per_cluster", 50), ("--nredo", closed_loop.NREDO),
                        ("--max_speech_len", closed_loop.MAX_SPEECH_LEN),
                        ("--gt_length", closed_loop.GT_LENGTH), ("--pred_iters", 4),
                        ("--s2a_steps", 4)]:
        assert f'"{flag}", "{value}"' in src, flag
    assert "make_dataset(os.path.join(root, \"data\"))" in src
    assert inspect.signature(jax_script.make_dataset).parameters["n_speakers"].default == 3
    assert inspect.signature(jax_script.make_dataset).parameters["n_utts"].default == 20
    seen = {}
    monkeypatch.setattr(closed_loop, "run", lambda root, **kw: seen.update(root=root, **kw))
    closed_loop.main(["--root", str(tmp_path), "--codec_steps", "30", "--device", "cpu"])
    root = str(tmp_path)
    assert seen["codec_recipe"] == closed_loop.CODEC_YAML.format(root=root, codec_steps=30,
                                                                 codec_eval=50)
    assert seen["t2s_recipe"] == closed_loop.T2S_YAML.format(root=root, k=32, steps=300)
    assert seen["s2a_recipe"] == closed_loop.S2A_YAML.format(root=root, k=32, steps=300)
    assert (seen["k"], seen["device"]) == (32, "cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(SystemExit) as e:
            closed_loop.main(["--root", str(tmp_path)])
        assert e.value.code == 2
    with pytest.raises(SystemExit) as e:  # no default root, which an old loop could fill
        closed_loop.main(["--device", "cpu"])
    assert e.value.code == 2


def test_a_stage_whose_artifact_exists_is_skipped(tmp_path):
    (tmp_path / "done").mkdir()
    r = closed_loop.run_stage("x", ["false"], str(tmp_path), done_path=str(tmp_path / "done"))
    assert r["skipped"] and r["seconds"] == 0.0
    with pytest.raises(SystemExit, match="stage y FAILED"):
        closed_loop.run_stage("y", ["false"], str(tmp_path))
    assert (tmp_path / "logs" / "y.log").exists()


def test_a_stage_runs_a_module_of_the_port_from_the_checkout(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = closed_loop.run_stage("help", [sys.executable, "-m", "edm_tts_tpu_torch.closed_loop",
                                       "--help"], str(tmp_path))
    assert not r["skipped"] and r["launches"] is None
    assert "--root ROOT" in (tmp_path / "logs" / "help.log").read_text()


def test_launch_line_is_parsed():
    log = 'step 1\nkernel launches: {"attention": 1}\nkernel launches: {"attention": 2}\n'
    assert closed_loop.launch_counts(log) == {"attention": 2}
    assert closed_loop.launch_counts("no line") is None


@pytest.mark.parametrize("kind,kw", [
    ("fixed", dict(order=2, param=12)),
    ("fixed", dict(order=3, blocksize=4096)),
    ("verbatim", dict(blocksize=4096)),
    ("verbatim", {}),
])
def test_flac_writer_copy_is_byte_identical(kind, kw):
    rng = np.random.default_rng(len(kind) + len(kw))
    t = np.arange(9000) / 16000
    pcm = np.round(8000 * np.sin(2 * np.pi * 220 * t) + 300 * rng.standard_normal(t.shape))
    pcm = pcm.astype(np.int64)[None]
    out = port_flac.encode_flac(pcm, 16000, subframe_kind=kind, **kw)
    assert out == test_flac.encode_flac(pcm, 16000, subframe_kind=kind, **kw)


def test_flac_writer_copy_has_the_same_code():
    def body(module):
        tree = ast.parse(inspect.getsource(module))
        tree.body = tree.body[1:]  # the module docstring
        return ast.dump(tree)

    assert body(port_flac) == body(test_flac)
    assert os.path.basename(port_flac.__file__) == "flac_encoder.py"
