"""What the serving configurations and their drivers share: the served
deployment as the drivers see it, the window over HTTP (warm-up, the load
generator in a process of its own, the engine's counters, the sample for
the check), and the comparison of served images with the reference's."""

from __future__ import annotations

import base64
import gc
import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench.lib import flops
from perfbench.lib.png import read_png
from perfbench.lib.window import Window

LOADGEN = Path(__file__).resolve().parent / "loadgen.py"


class Served:
    """An engine behind its HTTP server on a thread of its own.  A
    configuration's subclass names its traced modules (``modules``), its
    request body (``request``) and the operations of one call of a span
    (``counts``).  ``batch_log`` keeps each batch's padded seed list: the
    engine samples policy actions from one generator per batch, seeded by
    its first seed, so the reference needs the batch and the slot."""

    def __init__(self, cfg: dict, pipeline, engine, server, layouts: dict):
        self.cfg, self.pipeline, self.engine, self.server = cfg, pipeline, engine, server
        self.layouts = layouts
        self.batch_log: List[List[int]] = []
        message = engine._message

        def logged(requests):
            msg = message(requests)
            self.batch_log.append([int(s) for s in msg["seeds"]])
            return msg

        engine._message = logged
        self.thread = threading.Thread(target=server.serve_forever, name="pb-http", daemon=True)
        self.thread.start()
        host, port = server.server_address[:2]
        self.url = f"http://{host}:{port}"
        self._work: Dict[tuple, flops.Count] = {}

    def modules(self) -> Dict[str, object]:
        raise NotImplementedError

    def request(self, text: str, seed: int, source=None) -> tuple:
        raise NotImplementedError

    def counts(self, span: str, rows: int) -> flops.Count:
        raise NotImplementedError

    def work(self, span: str, rows: int) -> flops.Count:
        """The operations of one call of ``span`` at ``rows`` rows."""
        if (span, rows) not in self._work:
            self._work[span, rows] = self.counts(span, rows)
        return self._work[span, rows]

    def free(self) -> None:
        """Stop the server and the engine and let go of the models."""
        import torch

        self.server.shutdown()
        self.server.server_close()
        self.engine.shutdown()
        self.thread.join(10)
        self.pipeline = self.engine = self.server = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _post_all(url: str, bodies: list) -> None:
    """POST each (path, body) at once from a thread each; raise on any
    answer other than 200."""
    from http.client import HTTPConnection
    from urllib.parse import urlparse

    u = urlparse(url)
    errors = []

    def one(path, body):
        conn = HTTPConnection(u.hostname, u.port, timeout=600)
        try:
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                errors.append(f"{resp.status}: {data[:300]!r}")
        finally:
            conn.close()

    threads = [threading.Thread(target=one, args=pb) for pb in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"warm-up request failed: {errors[0]}")


def _resolve(body: dict, images: list) -> dict:
    return {k: images[v["ref"]] if isinstance(v, dict) and "ref" in v else v
            for k, v in body.items()}


def warm(system: Served, wl: dict, images: list) -> None:
    """Warm the shapes the cell's traffic uses, once: a burst of each size
    in the cell's ``warm`` list, sent through HTTP at once."""
    import torch

    spec = wl["traffic"]
    warm_seed = 2**31  # above every request seed
    for n in wl["warm"]:
        bodies = []
        for k in range(n):
            src = {"ref": k % len(images)} if images else None
            path, body = system.request(spec["texts"][k % len(spec["texts"])], warm_seed, src)
            bodies.append((path, _resolve(body, images)))
            warm_seed += 1
        _post_all(system.url, bodies)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def drive(plan: dict, during) -> dict:
    """Run the load generator over the plan; ``during(t0)``, if given, runs
    in this process while the window is open.  Returns its result."""
    gen = subprocess.Popen([sys.executable, str(LOADGEN)], stdin=subprocess.PIPE,
                           stdout=subprocess.PIPE, text=True)
    feeder = threading.Thread(target=lambda: (gen.stdin.write(json.dumps(plan)), gen.stdin.close()),
                              daemon=True)
    feeder.start()
    try:
        first = gen.stdout.readline()
        if not first.startswith("T0 "):
            raise RuntimeError(f"the load generator did not start: {first!r}")
        if during is not None:
            during(float(first.split()[1]))
        out = gen.stdout.read()
    finally:
        gen.wait()
        feeder.join()
    if gen.returncode != 0:
        raise RuntimeError(f"the load generator failed with code {gen.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def serve_window(system: Served, wl: dict, seconds: float, plan: dict,
                 inputs: List[dict], sources, during=None) -> Window:
    """Warm, then drive ``plan`` (a driver's requests, ``mode`` and
    ``keep``) against the server for ``seconds``, and gather the window:
    the load generator's records, the engine's counters over the window,
    and the sampled answers (decoded, with their inputs and batch) for the
    configuration's check.  ``sources``: (uint8 arrays, base64 PNGs) of the
    cell's source images, or None."""
    src_arrays, src_pngs = sources if sources else ([], [])
    plan = dict(plan, url=system.url, seconds=seconds, images=src_pngs,
                grace_s=float(wl["traffic"].get("grace_s", 60.0)))
    t_warm = time.monotonic()
    warm(system, wl, src_pngs)
    print(f"set-up: warm-up {time.monotonic() - t_warm:.2f} s", file=sys.stderr)
    engine = system.engine
    before = engine.stats()
    result = drive(plan, during)
    after = engine.stats()
    new_waits = after["completed"] - before["completed"]
    new_batches = after["batches"] - before["batches"]
    counters = {
        "stats_before": before, "stats_after": after,
        "wait_ms": list(engine._wait_ms)[-new_waits:] if 0 < new_waits <= 512 else [],
        "dispatch_ms": list(engine._dispatch_ms)[-new_batches:] if 0 < new_batches <= 512 else [],
    }
    records = result["records"]
    sample = []
    for i in sorted(int(k) for k in result["bodies"]):
        inp = inputs[i]
        batch = next((b for b in system.batch_log if inp["seed"] in b), None)
        if batch is None:
            raise RuntimeError(f"request {i} (seed {inp['seed']}) is in no batch the engine ran")
        item = {"text": inp["text"], "seed": inp["seed"], "batch": (batch, batch.index(inp["seed"])),
                "image": read_png(base64.b64decode(result["bodies"][str(i)]))}
        what = f"sample: request {i}, seed {inp['seed']}, batch of {len(batch)}"
        if inp["source"] is not None:
            item["source"] = src_arrays[inp["source"]]
            what += f", source {item['source'].shape[1]}x{item['source'].shape[0]}"
        print(f"{what}: {inp['text']!r}", file=sys.stderr)
        sample.append(item)
    missing = [i for i in plan["keep"] if i < len(records) and str(i) not in result["bodies"]]
    return Window(t0=result["t0"], t1=result["t1"], records=records, counters=counters,
                  sample=sample, missing=missing)


def image_numbers(served: List[np.ndarray], ref: np.ndarray) -> Dict[str, float]:
    """Over the sampled images: the worst image's mean |served - ref| in
    uint8 levels, and its share (%) of channels more than 2 ... 32 levels
    off; and the largest share of the reference's channels at 0 or 255."""
    diff = np.abs(np.stack(served).astype(np.int16) - ref.astype(np.int16))
    diff = diff.reshape(len(served), -1)
    out = {"img_mae_max": float(diff.mean(axis=1).max())}
    for level in (2, 4, 8, 16, 32):
        out[f"px_off{level}_pct_max"] = float(100.0 * (diff > level).mean(axis=1).max())
    clipped = (ref == 0) | (ref == 255)
    out["ref_clipped_pct_max"] = float(100.0 * clipped.reshape(len(served), -1).mean(axis=1).max())
    return out


def split_compared(numbers: Dict[str, float], limits: Dict[str, float], log) -> Dict[str, tuple]:
    """name -> (value, limit) for the numbers the configuration compares
    (those it gives a limit); the rest are printed as not compared."""
    for name, value in numbers.items():
        if name not in limits:
            print(f"not compared: {name} = {value!r}", file=log)
    return {name: (numbers[name], limit) for name, limit in limits.items()}
