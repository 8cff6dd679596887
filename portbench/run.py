"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``edm_tts_tpu_torch``)
and ``BENCHMARK.json``, on a machine with the CUDA cards the cell asks
for. The cell's traffic kind builds the program from the seed, warms it
up at the cell's shapes, measures ``--seconds``, and has the reference
judge what the window produced. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, then ``compared``);
the numbers compared with their limits are also the last lines of
standard error. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced run.

``--control`` runs the cell's control in the program's place, one
precision step below the configuration; ``--control half_batch`` (a
training cell) the reference with half of each batch left out of the
step's mean. Neither is part of a benchmark run: they read the upper ends
of the correctness limits. Exits 2 without a
result where the cards are missing, 3 where a forbidden module (JAX or the
JAX package) is loaded after the window.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (its age from
    ``/proc``; the import of this module where that is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 60 else T_IMPORT
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def cache_dirs(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def host_speed() -> tuple[float, float | None]:
    """The host's pace now: the seconds a fixed loop of Python takes (the
    window's host work is the interpreter dispatching launches), and the
    mean clock of the cores in MHz where ``/proc/cpuinfo`` gives one."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    loop = time.perf_counter() - t0
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        mhz = []
    return loop, (sum(mhz) / len(mhz) if mhz else None)


def nvidia_smi(fields: str) -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def main(argv: list[str] | None = None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", nargs="?", const="precision", choices=("precision", "half_batch"),
                   help="run the cell's control (or, for a training cell, the reference with "
                   "half of each batch) in the program's place")
    args = p.parse_args(argv)

    from portbench import harness

    cache_dirs(harness.ROOT)
    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: {args.workload!r} is not a workload of BENCHMARK.json", file=sys.stderr)
        return 2
    spec = harness.cell(args.workload)
    if (spec["config"], spec["mix"]) != (entry["config"], entry["traffic"]):
        print(f"portbench: the cell file names {spec['config']!r} under {spec['mix']!r}, "
              f"BENCHMARK.json {entry['config']!r} under {entry['traffic']!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = harness.Context(args.workload, spec, harness.config(spec["config"]), args.seed,
                          args.seconds, bool(args.trace), device, t_start, args.control)
    speed = host_speed()
    run = harness.traffic_kind(spec["traffic"]["kind"]).run(ctx)
    run.notes["host: a fixed Python loop (s) and the cores' mean MHz at start, at end; usable "
              "cpus"] = (speed, host_speed(), len(os.sched_getaffinity(0)))
    run.notes["card: SM clock, temperature, power draw at end"] = nvidia_smi(
        "clocks.sm,temperature.gpu,power.draw")
    times = sorted(c["end"] - c["start"] for c in run.untraced_calls())
    if times:
        run.notes["seconds a call or step: fastest, median, slowest"] = (
            times[0], times[len(times) // 2], times[-1])

    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    e2e, layer = harness.cell_metrics(bench, args.workload)
    metrics = harness.read_metrics(run, layer if args.trace else e2e)
    missing = [m["name"] for m in (layer if args.trace else e2e) if m["name"] not in metrics
               and args.workload in m.get("workloads", [])]
    if missing:
        print(f"portbench: no reading for {missing}", file=sys.stderr)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                   "memory_peak_bytes": int(run.extra.get("memory_peak_bytes", 0)),
                   "power_limit": nvidia_smi("power.limit")}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    for k, v in run.notes.items():
        ctx.say(f"{k}: {v}")
    for c in run.checks:
        print(f"compared {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'OVER'}", file=sys.stderr)
    print(harness.result_line(run, metrics, device_info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
