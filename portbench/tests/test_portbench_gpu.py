"""On the card: each cell's control comes out as not correct at the cell's
own size, on three seeds, and a sound short run is correct with the
benchmark's count of K5's and K1's launches matching the port's counters.

Marked ``gpu``; each test skips where there is no CUDA device. Run them
on the card from the repository's root:

    python3 -m pytest --noconftest -m gpu portbench/tests/test_portbench_gpu.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(*args: str) -> tuple[dict, str]:
    proc = subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("workload,seconds", [("serve_offline_b16", "4"), ("s2a_train_b32", "1"),
                                              ("serve_open_poisson", "10")])
def test_the_control_is_not_correct(card, workload, seconds, seed):
    line, _ = _run("--workload", workload, "--seed", str(seed), "--seconds", seconds,
                   "--trace", "0", "--control")
    print(f"control {workload} seed {seed}: {line['compared']}")  # the limits' upper readings
    assert line["correct"] is False, line["compared"]


def test_a_short_sound_run_is_correct_and_counts_match(card):
    line, err = _run("--workload", "serve_offline_b16", "--seed", "21", "--seconds", "4",
                     "--trace", "0")
    assert line["correct"] is True, line["compared"]
    assert "crosscheck K5 shapes: match" in err and "crosscheck K1 shapes: match" in err
