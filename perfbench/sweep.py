#!/usr/bin/env python3
"""Find an open-loop cell's knee once: the highest rate its system sustains.

    python3 perfbench/sweep.py --workload sd15-preview-poisson --rates 6,7,8,9,10 \\
        --seconds 20 --seed 1 [--out sweep.jsonl]

One set-up, then one window per rate with the cell's own traffic at that
rate, each through the cell's driver (which warms its shapes first).  Per rate it prints the requests due, those answered by the window's
close, the backlog then (due, not yet answered), the served rate and the
p50 / p95 latency.  The cell's file then fixes its rate at about four fifths
of the knee; the benchmark's runs never sweep.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import run  # noqa: E402
from perfbench.lib.stats import latencies, percentile  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    wl = run.load_json(run.BENCH_DIR / "workloads" / f"{args.workload}.json")
    cfg = run.load_json(run.BENCH_DIR / "configs" / f"{wl['config']}.json")
    config = run.load_module(run.BENCH_DIR / "configs" / f"{wl['config']}.py")
    driver = run.load_module(run.BENCH_DIR / "drivers" / f"{wl['driver']}.py")
    system = config.build(cfg, args.seed, device)
    rows = []
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            spec = dict(wl["traffic"], rate_rps=rate, check_sample=0, grace_s=120.0)
            win = driver.run(system, dict(wl, traffic=spec), args.seed + i, args.seconds)
            recs = win.records
            by_close = [r for r in recs if r["ok"] and r["done"] <= win.t1]
            lat = latencies(recs)
            row = {"rate_rps": rate, "due": len(recs), "answered_by_close": len(by_close),
                   "backlog_at_close": len(recs) - len(by_close),
                   "served_rps": len(by_close) / args.seconds,
                   "failed": sum(1 for r in recs if not r["ok"]),
                   "p50_s": percentile(lat, 50), "p95_s": percentile(lat, 95),
                   "late_send_max_s": max(r["sent"] - r["due"] for r in recs)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        system.free()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps({"workload": args.workload, **row}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
