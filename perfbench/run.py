#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process per run.  It builds the cell's configuration on the card from
the seed (``perfbench/configs/<config>.py``), hands it to the cell's driver
(``perfbench/drivers/<driver>.py``), which warms the shapes the cell's
traffic uses and drives that traffic for ``--seconds``, reads the metrics
from the window's records, frees the program, checks the driver's sample
of the answers against the plain reference (``perfbench/reference/``), and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``compared`` (each number checked, with its limit;
the same lines close standard error).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read by ``perfbench/metrics/<metric>.py`` from the run's
records; the traced run profiles a steady slice of its window (the cell's
``trace`` entry).  ``--variant int8`` serves the program's int8 path, the
lower-precision control of ``correct``; the benchmark's own runs never pass
it.  Exit codes: 0 a result printed; 2 bad arguments; 3 no card, or fewer
than the cell asks for; 4 JAX or the JAX package loaded in this process.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

_T_CALL = time.monotonic()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "consolver_tpu")


def process_start() -> float:
    """``time.monotonic()`` at this process's start (Linux: its start tick
    in ``/proc/self/stat`` against ``/proc/uptime``); the import time of
    this module elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _T_CALL


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: str, wl: dict, cfg: dict, bench: dict, seed: int, seconds: float, trace: bool,
             device, variant=None, t_start=None) -> dict:
    """One run of the cell on ``device``; returns the result object."""
    import torch

    from perfbench.lib import trace as tracing

    t_start = process_start() if t_start is None else t_start
    config = load_module(BENCH_DIR / "configs" / f"{wl['config']}.py")
    driver = load_module(BENCH_DIR / "drivers" / f"{wl['driver']}.py")
    metrics = cell_metrics(bench, cell, "per_layer" if trace else "end_to_end")
    readers = {m["name"]: load_module(BENCH_DIR / "metrics" / f"{m['name']}.py") for m in metrics}

    t_build = time.monotonic()
    system = config.build(cfg, seed, device, variant)
    print(f"set-up: imports and CUDA {t_build - t_start:.2f} s, build and fill "
          f"{time.monotonic() - t_build:.2f} s", file=sys.stderr)
    during = None
    if trace:
        spans, profiler = tracing.Spans(), tracing.Profiler()
        for name, module in system.modules().items():
            spans.attach(module, name)
        tr = wl["trace"]

        def during(t0):
            profiler.trace_slice(t0, tr["start_s"], tr["seconds"], tr["margin_s"])

    window = driver.run(system, wl, seed, seconds, during)
    print(f"set-up: {window.t0 - t_start:.2f} s in all", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    peak = max(peak, window.memory_peak_bytes)
    rec = {"setup_s": window.t0 - t_start, "t0": window.t0, "t1": window.t1,
           "requests": window.records, **window.counters}
    if trace:  # a driver over several cards brings its workers' reduced trace itself
        spans.detach()
        rec["work"] = system.work
        if "trace" not in rec:
            rec["trace"] = profiler.reduce()
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(rec)
        if v is not None and math.isfinite(v):
            values[m["name"]] = {"value": v, "unit": m["unit"]}
        elif v is not None:
            print(f"metric {m['name']} reads {v}", file=sys.stderr)
    failed = sum(1 for r in window.records if not r["ok"])

    # the check: the driver's sample of the answers, after the program is freed
    layouts = system.layouts
    system.free()
    del system
    t_check = time.monotonic()
    compared = config.check(cfg, seed, layouts, window.sample, device) if window.sample else {}
    print(f"check: {len(window.sample)} answers against the reference in "
          f"{time.monotonic() - t_check:.2f} s", file=sys.stderr)
    correct = (failed == 0 and not window.missing and bool(compared)
               and all(limit is not None and value <= limit for value, limit in compared.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(wl.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
    out = {"correct": correct, "attempted": len(window.records), "failed": failed,
           "metrics": values, "device": dev}
    if trace:
        out["breakdown"] = rec["trace"]["breakdown"]
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    out["compared"]["failed_requests"] = {"value": failed, "limit": 0}
    out["compared"]["missing_sampled"] = {"value": len(window.missing), "limit": 0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", default=None, help="int8: the program's int8 path (the control)")
    args = ap.parse_args(argv)
    t_start = process_start()
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    wl = load_json(BENCH_DIR / "workloads" / f"{args.workload}.json")
    cfg = load_json(BENCH_DIR / "configs" / f"{wl['config']}.json")
    chips = int(cells[args.workload]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(args.workload, wl, cfg, bench, args.seed, args.seconds, bool(args.trace),
                   device, args.variant, t_start)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    out["device"]["power_limit_w"] = power_limit_w()
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
