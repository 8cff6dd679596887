"""What every cell shares: finding its files by name, the run record the
traffic kinds fill, reading the metrics, and the result line.

A cell ``<cell>`` is ``cells/<cell>.json`` (its configuration, its traffic
kind and the kind's parameters, its trace slice and its correctness
limits); its configuration is ``configs/<config>.json``; its traffic kind
is the module ``traffic/<kind>.py``, whose ``run(ctx)`` drives the program
and fills a ``Run``; each metric ``<metric>`` is ``metrics/<metric>.py``,
whose ``read(run)`` returns the number or None where the run holds nothing
for it. ``BENCHMARK.json`` says which metrics a cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names the benchmark's process may never hold: JAX and
# the JAX package (compared whole: the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "edm_tts_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str) -> dict:
    """``cells/<name>.json`` with its traffic mix (``traffic/<mix>.json``,
    the kind and its parameters) read in place of the mix's name."""
    path = PKG / "cells" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no cell {name!r} ({path} is missing)")
    spec = load_json(path)
    return {**spec, "mix": spec["traffic"],
            "traffic": load_json(PKG / "traffic" / f"{spec['traffic']}.json")}


def config(name: str) -> dict:
    return load_json(PKG / "configs" / f"{name}.json")


def traffic_kind(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def metric_module(name: str):
    """``metrics/<name>.py`` (names may hold dots, so loaded by path)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name.replace('.', '__')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, workload: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return e2e, layer


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names present in ``modules`` (sys.modules)."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a traffic kind is given: the cell, its configuration, the run's
    arguments, the device and the process's start on the host clock.
    ``control``: None, or what runs in the program's place ("precision":
    the cell's control; "half_batch": a training cell's planted fault)."""
    cell: str
    spec: dict
    config: dict
    seed: int
    seconds: float
    traced: bool
    device: Any
    t_start: float
    control: str | None = None

    def new_run(self) -> "Run":
        return Run(self.cell, self.seed)

    def say(self, *parts) -> None:
        """A line of the run's own readings (standard error)."""
        print(f"[{self.cell}]", *parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Check:
    """One number compared with its limit (``value <= limit`` passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a run measured. Times are ``time.perf_counter`` seconds.

    ``requests``: one dict per request due in the window (``due``,
    ``start`` of the engine call that carried it, ``done`` or None,
    ``audio_s``); ``calls``: one dict per engine call or optimizer step
    in the window (``start``, ``end``, ``rows``, ``flops``, ``traced``);
    ``trace``: ``trace.Slice`` of the traced run; ``extra``: the kind's
    own readings for its metrics."""
    cell: str
    seed: int
    setup_s: float = math.nan
    t_open: float = math.nan
    t_close: float = math.nan
    attempted: int = 0
    failed: int = 0
    requests: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    trace: Any = None
    extra: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def untraced_calls(self) -> list:
        return [c for c in self.calls if not c.get("traced")]


def read_metrics(run: Run, entries: list[dict]) -> dict[str, dict]:
    """``{name: {"value", "unit"}}`` for each entry whose reader found
    something; a metric that must be there and reads None is an error."""
    out = {}
    for m in entries:
        value = metric_module(m["name"]).read(run)
        if value is None:
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run: Run, metrics: dict, device: dict) -> str:
    """The last line: correct, attempted, failed, metrics, device[,
    breakdown], then the compared numbers with their limits."""
    line: dict[str, Any] = {
        "correct": bool(run.checks) and all(c.ok for c in run.checks),
        "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics, "device": device,
    }
    if run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return json.dumps(line, allow_nan=True)
