"""The port's closed-loop rehearsal run whole on the CPU: the seven stages of
``edm_tts_tpu_torch.closed_loop.run`` through the port's CLIs, at the JAX
script's tiny recipes.

Each stage's command, ``python -m edm_tts_tpu_torch.<cli> ...``, runs in
this process as the interpreter would run it (``runpy`` as ``__main__``
with the command's argv and its output in the stage's log), on two torch
threads: six fresh interpreters, each importing torch, numpy and scipy
without cached byte code, would take most of the file's time budget. That
a stage runs as a real subprocess from the checkout, with its log, its skip
and its failure, is held in tests/test_torch_closed_loop.py.

Cut to fit a test: 2 speakers x 4 utterances, K 8, 2 t2s and s2a steps and
1 codec step, with the codec template's eval and save interval set to that
step so ``best_model`` is exported (the CLI's interval, ``max(50,
codec_steps // 3)``, would take 50 steps of several seconds each on the
CPU, as the template's discriminator keys are not DiscriminatorConfig
fields and the full MPD/MRD trains in both packages). Checks every
artifact: the codec export, the centroids, the shards' ranges, both exports
loading back, the logged losses finite, and the JAX script's final check on
the wav (16 kHz, ``GT_LENGTH * 320`` samples, nonzero RMS).
"""

import contextlib
import json
import logging
import math
import runpy
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from edm_tts_tpu_torch import closed_loop
from edm_tts_tpu_torch.data.token_shards import iter_token_shards
from edm_tts_tpu_torch.utils import hub

K, STEPS, CODEC_STEPS, SPEAKERS, UTTS = 8, 2, 1, 2, 4
STAGES = ("codec_gan_training", "hubert_kmeans", "dump_tokens", "t2s_training",
          "s2a_training", "inference")


@pytest.fixture
def stages_in_process(monkeypatch):
    """``subprocess.run`` for the stages: a ``python -m
    edm_tts_tpu_torch.<cli>`` command from the checkout runs in this
    process; any other command (the native decoders' g++ builds) runs as
    given. Restores the threads, argv and logging the stages may change."""
    real_run, threads = subprocess.run, torch.get_num_threads()
    ran = []

    def run(cmd, stdout=None, stderr=None, cwd=None, **kw):
        if cmd[:2] != [sys.executable, "-m"] or not cmd[2].startswith("edm_tts_tpu_torch."):
            return real_run(cmd, stdout=stdout, stderr=stderr, cwd=cwd, **kw)
        assert cwd == closed_loop.CHECKOUT and stderr == subprocess.STDOUT, (cwd, stderr)
        ran.append(cmd)
        root = logging.getLogger()
        handlers, level, argv = root.handlers[:], root.level, sys.argv
        sys.argv = [cmd[2], *cmd[3:]]
        code = 0
        try:
            with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stdout), \
                    warnings.catch_warnings():
                # a module another stage imported runs again as __main__, as a
                # fresh interpreter would run it
                warnings.filterwarnings("ignore", ".*found in sys.modules", RuntimeWarning)
                runpy.run_module(cmd[2], run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else int(e.code is not None)
        finally:
            sys.argv = argv
            root.handlers[:] = handlers
            root.setLevel(level)
        return subprocess.CompletedProcess(cmd, code)

    torch.set_num_threads(2)
    monkeypatch.setattr(subprocess, "run", run)
    yield ran
    torch.set_num_threads(threads)


def test_closed_loop_runs_every_stage_on_the_cpu(tmp_path, stages_in_process):
    root = str(tmp_path / "loop")
    result = closed_loop.run(
        root,
        codec_recipe=closed_loop.CODEC_YAML.format(root=root, codec_steps=CODEC_STEPS,
                                                   codec_eval=CODEC_STEPS),
        t2s_recipe=closed_loop.T2S_YAML.format(root=root, k=K, steps=STEPS),
        s2a_recipe=closed_loop.S2A_YAML.format(root=root, k=K, steps=STEPS),
        hubert=closed_loop.make_tiny_hubert(), k=K, device="cpu", n_speakers=SPEAKERS,
        n_utts=UTTS)
    assert [result[name]["cmd"] for name in STAGES] == stages_in_process
    for name in STAGES:
        r = result[name]
        assert not r["skipped"] and r["launches"] is None, name  # no launch line on the CPU
        assert r["cmd"][1] == "-m" and r["cmd"][2].startswith("edm_tts_tpu_torch."), r["cmd"]
        assert r["cmd"][-2:] == ["--device", "cpu"], r["cmd"]
    assert result["wav"]["samples"] == closed_loop.GT_LENGTH * 320 and result["wav"]["rms"] > 0

    codec = hub.load_codec(f"{root}/codec/best_model", device="cpu")
    assert codec.config.n_codebooks == 4 and codec.config.codebook_size == 64
    centers = np.load(hub.find_centroids(f"{root}/hubert_semantic"))
    assert centers.shape == (K, 32) and np.isfinite(centers).all()
    items = list(iter_token_shards(f"{root}/codes"))
    assert len(items) == SPEAKERS * UTTS
    for it in items:
        a, s = it["acoustic_tokens"], it["semantic_tokens"]
        assert a.shape == (4, s.shape[0]) and 150 < s.shape[0] <= 200
        assert 0 <= a.min() and a.max() < 64 and 0 <= s.min() and s.max() < K
        assert len(it["transcription_bytes"]) > 0
    t2s = hub.load_t2s(f"{root}/t2s/export", device="cpu")
    s2a = hub.load_s2a(f"{root}/s2a/export", device="cpu")
    assert t2s.cfg.semantic_vocab_size == K and s2a.cfg.num_semantic_tokens == K
    assert s2a.cfg.codec == codec.config
    logged = [json.loads(line) for d in ("codec", "t2s", "s2a")
              for line in open(f"{root}/{d}/metrics.jsonl")]
    losses = [v for r in logged for k, v in r.items() if "loss" in k]
    assert losses and all(math.isfinite(v) for v in losses)
