"""The load generator: a process of its own, so that its threads do not take
the server's interpreter lock.

    python perfbench/lib/loadgen.py < plan.json

The plan (one JSON object on standard input) holds ``url``, ``mode``
(``open``: each request is sent at its due offset, whether or not earlier
ones have answered; ``closed``: one client sends the next request when the
last one has answered, while the window is open), ``seconds``, ``grace_s``
(how long past the window's close to wait for answers), ``requests``
(``path``, ``body``, and ``offset`` in the open loop; a body field
``{"ref": k}`` stands for ``images[k]``), ``images`` and ``keep`` (indices
whose response bodies come back for the check).

The first line written to standard output is ``T0 <monotonic seconds>``,
the window's start; the last is one JSON object: a record per request sent
(``due``, ``sent``, ``done``, ``ok``, ``status``, ``bytes``) and the kept
bodies.  Times are ``time.monotonic()``, which every process of the machine
shares.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.client import HTTPConnection
from urllib.parse import urlparse

MAX_IN_FLIGHT = 128  # open loop: threads sending, far above what a cell keeps waiting


def _post(host: str, port: int, path: str, body: bytes, timeout: float):
    conn = HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data
    finally:
        conn.close()


def run(plan: dict) -> dict:
    url = urlparse(plan["url"])
    host, port = url.hostname, url.port
    seconds, grace = float(plan["seconds"]), float(plan.get("grace_s", 60.0))
    keep = set(plan.get("keep", []))
    images = plan.get("images", [])

    def body_of(r):  # a {"ref": k} field stands for the plan's k-th image
        return json.dumps({k: images[v["ref"]] if isinstance(v, dict) and "ref" in v else v
                           for k, v in r["body"].items()}).encode()

    bodies = [body_of(r) for r in plan["requests"]]
    records: list = []
    kept: dict = {}
    lock = threading.Lock()
    t0 = time.monotonic() + 0.05
    print(f"T0 {t0!r}", flush=True)
    deadline = t0 + seconds + grace

    def one(i: int, due: float) -> dict:
        sent = time.monotonic()
        rec = {"i": i, "due": due, "sent": sent, "done": None, "ok": False, "status": None,
               "bytes": 0}
        try:
            status, data = _post(host, port, plan["requests"][i]["path"], bodies[i],
                                 max(1.0, deadline - sent))
            rec.update(done=time.monotonic(), status=status, bytes=len(data), ok=status == 200)
            if rec["ok"] and i in keep:
                payload = json.loads(data)
                with lock:
                    kept[i] = payload["image_png_b64"]
        except (OSError, ValueError) as exc:  # refused, reset, timed out, bad JSON
            rec["error"] = f"{type(exc).__name__}: {exc}"
        with lock:
            records.append(rec)
        return rec

    if plan["mode"] == "open":
        with ThreadPoolExecutor(max_workers=MAX_IN_FLIGHT) as pool:
            futures = []
            for i, r in enumerate(plan["requests"]):
                due = t0 + float(r["offset"])
                if due >= t0 + seconds:
                    break
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                futures.append(pool.submit(one, i, due))
            for f in futures:
                f.result()
    elif plan["mode"] == "closed":
        for i in range(len(plan["requests"])):
            now = time.monotonic()
            if now >= t0 + seconds:
                break
            one(i, now)
        else:
            raise RuntimeError(f"the closed loop ran out of its {len(plan['requests'])} "
                               "planned requests before the window closed")
    else:
        raise ValueError(f"unknown mode {plan['mode']!r}")
    records.sort(key=lambda r: r["i"])
    result = {"t0": t0, "t1": t0 + seconds, "records": records, "bodies": kept}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    run(json.load(sys.stdin))
