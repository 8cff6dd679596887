"""The harness finds what a cell needs from its files alone, BENCHMARK.json
keeps the contract's shape, and nothing the benchmark runs loads JAX or
the JAX package (top-level names compared whole)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_from_its_files(workload):
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    spec = harness.cell(workload)
    assert (spec["config"], spec["mix"]) == (entry["config"], entry["traffic"])
    cfg = harness.config(spec["config"])
    assert cfg["name"] == spec["config"]
    conf = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert conf["file"] == f"portbench/configs/{spec['config']}.json"
    assert conf["reduced"] == cfg["reduced"]
    assert hasattr(harness.traffic_kind(spec["traffic"]["kind"]), "run")
    e2e, layer = harness.cell_metrics(BENCH, workload)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert callable(harness.metric_module(m["name"]).read)
    for m in layer:
        assert m["moves"] in names
    assert set(spec["limits"]) <= {"canvas", "length_gap", "t2s_gap", "t2s_gap_mean",
                                   "s2a_start", "s2a_state", "s2a_gap", "s2a_gap_mean",
                                   "decode_err", "answer", "loss", "grad", "update"}


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path, monkeypatch):
    for sub in ("cells", "configs", "metrics", "traffic"):
        (tmp_path / sub).mkdir()
    (tmp_path / "cells" / "new_cell.json").write_text(json.dumps(
        {"config": "new_config", "traffic": "new_mix", "limits": {}}))
    (tmp_path / "traffic" / "new_mix.json").write_text(json.dumps({"kind": "offline_batches",
                                                                   "rows": 2}))
    (tmp_path / "configs" / "new_config.json").write_text(json.dumps({"name": "new_config"}))
    (tmp_path / "metrics" / "new_metric.layer.py").write_text(
        "def read(run):\n    return 2.0 * run.seed\n")
    monkeypatch.setattr(harness, "PKG", tmp_path)
    spec = harness.cell("new_cell")
    assert spec["traffic"] == {"kind": "offline_batches", "rows": 2}
    assert harness.config("new_config") == {"name": "new_config"}
    run = harness.Run("new_cell", 21)
    got = harness.read_metrics(run, [{"name": "new_metric.layer", "unit": "x"}])
    assert got == {"new_metric.layer": {"value": 42.0, "unit": "x"}}


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["edm_tts_tpu_torch", "edm_tts_tpu_torch.ops", "jaxtyping",
                                      "flaxen", "torch"]) == []
    assert harness.forbidden_modules(["jax.numpy", "edm_tts_tpu.models", "optax",
                                      "jaxlib"]) == ["edm_tts_tpu", "jax", "jaxlib", "optax"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not _imports(path) & {"edm_tts_tpu_torch", *harness.FORBIDDEN}, path
    code = ("import sys, portbench.reference.model, portbench.reference.noise, "
            "portbench.reference.shapes, portbench.check_serve, portbench.check_train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"edm_tts_tpu_torch", *harness.FORBIDDEN}


def test_no_benchmark_module_imports_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_a_whole_tiny_run_loads_no_forbidden_module():
    code = ("import sys\n"
            "from portbench.tests import tiny\n"
            "from portbench.traffic import offline_batches, train_steps\n"
            "from portbench import harness\n"
            "offline_batches.run(tiny.context(tiny.OFFLINE, tiny.SERVE_CONFIG))\n"
            "train_steps.run(tiny.context(tiny.TRAIN, tiny.TRAIN_CONFIG))\n"
            "print('FORBIDDEN', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    assert "FORBIDDEN []" in out.stdout


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "serve_offline_b16",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 2 and proc.stdout == ""
