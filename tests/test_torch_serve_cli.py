"""``python -m consolver_torch serve`` (``consolver_torch/cli/serve.py``) on
the CPU with the tiny random models of smoke mode: the counterparts of the
CLI cases of ``tests/test_serve.py`` (the mesh flags at :272, here over 2
gloo ranks as ``tests/test_torch_dist.py`` runs them; ``--family both`` at
:482; ``--replicas`` at :655; the SIGTERM drain at :1079, here also end to
end in a server process), plus ``--prewarm`` / ``--prewarm-refine`` and
``--quantize-bits 4`` refused for the SD family.  Nothing here is numeric
beyond the served images matching the engines'.
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from consolver_torch.__main__ import main
from consolver_torch.cli import serve as cli_serve
from consolver_torch.dist import launch
from consolver_torch.dist.launch import free_port
from consolver_torch.serve import GenerationRequest, InferenceEngine
from consolver_torch.utils.png import decode_png, encode_png
from tests import torch_dist_workers as workers

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _args(*argv):
    return cli_serve._parser().parse_args([*argv, *CPU])


def _post(base, path, payload, timeout=300):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _get(base, path, timeout=30):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return json.load(r)


def _image(body):
    return decode_png(base64.b64decode(body["image_png_b64"]))


def test_serving_mesh_flags_over_two_ranks():
    """--shard makes every rank a data rank; --tp N without --shard needs a
    world of N ranks; with --shard the rest form the data axis; rank 0
    serves, rank 1 follows its batches; --family both is refused on a mesh."""
    out = launch.spawn(workers.serve_mesh_rank, 2, timeout_s=240)
    for r in out:
        assert r["none"] is None
        assert r["shard"] == ({"data": 2}, 2)
        assert r["tp2"] == ({"data": 1, "model": 2}, 1)
        assert r["shard_tp2"] == ({"data": 1, "model": 2}, 1)
        assert "must divide" in r["tp3"]
        assert r["descs"] == ["generate batch=2 latent=8 mesh={'data': 2}"]
        assert "--family both" in r["both"]
    assert out[1]["server"] is None
    assert out[0]["image"].shape == (16, 16, 3) and out[0]["image"].dtype == np.uint8


def test_replica_cli_semantics(monkeypatch):
    def ns(**kw):
        return argparse.Namespace(**{"shard": False, "tp": 1, "replicas": 0, **kw})

    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert cli_serve._replica_count(ns(), cuda) == 0
    assert cli_serve._replica_count(ns(replicas=1), cuda) == 0  # 1 replica = plain engine
    assert cli_serve._replica_count(ns(replicas=4), cuda) == 4
    assert cli_serve._replica_devices(cuda, 2) == ["cuda:0", "cuda:1"]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli_serve._replica_count(ns(replicas=2, shard=True), cuda)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli_serve._replica_count(ns(replicas=2, tp=2), cuda)
    with pytest.raises(SystemExit, match="visible devices"):
        cli_serve._replica_count(ns(replicas=99), cuda)


def test_replicas_serve_like_one_engine():
    """--replicas 2 (both on the host here): every replica its own model
    copy, the burst spread over both, a deterministic request's image equal
    to one engine's."""
    server, engines, descs = cli_serve.build_server(
        _args("--replicas", "2", "--batch-size", "2", "--port", "0", "--flush-ms", "20"))
    group = engines[0]
    try:
        assert descs == ["generate replicas=2 batch=2/replica latent=8"]
        assert group.engines[0].pipeline.unet is not group.engines[1].pipeline.unet
        futs = [group.submit(GenerationRequest(prompt=f"p{i}", seed=i, num_inference_steps=2,
                                               deterministic=True)) for i in range(4)]
        imgs = [f.result(timeout=300) for f in futs]
        assert all(p["requests"] > 0 for p in group.stats()["per_replica"])
        single = InferenceEngine(group.engines[0].pipeline, batch_size=2, latent_size=8)
        try:
            np.testing.assert_array_equal(
                imgs[3], single.generate(GenerationRequest(prompt="p3", seed=3, deterministic=True,
                                                           num_inference_steps=2), timeout=300))
        finally:
            single.shutdown()
    finally:
        group.shutdown()
        server.server_close()


def test_family_both_with_prewarm_serves_both_endpoints():
    """The CLI's wiring with --family both --prewarm (and --compile-cache,
    accepted and ignored): both endpoints on one server, one program per
    engine warmed before the bind."""
    server, engines, descs = cli_serve.build_server(_args(
        "--family", "both", "--port", "0", "--batch-size", "2", "--flush-ms", "20",
        "--prewarm", "--compile-cache", ".unused_cache"))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    try:
        assert len(engines) == 2 and descs == ["generate batch=2 latent=8",
                                               "edit batch=2 resolution=16"]
        assert [e.stats()["prewarmed"] for e in engines] == [1, 1]
        assert _get(base, "/healthz")["ok"]
        gen = _post(base, "/v1/generate", {"prompt": "smoke", "seed": 1,
                                           "num_inference_steps": 2})
        assert _image(gen).shape == (16, 16, 3)
        ref = np.random.default_rng(0).integers(0, 256, (24, 20, 3), dtype=np.uint8)
        edit = _post(base, "/v1/edit", {"instruction": "make it snow", "seed": 2,
                                        "num_inference_steps": 2,
                                        "image_png_b64": base64.b64encode(encode_png(ref)).decode()})
        assert _image(edit).shape == (16, 16, 3)
        assert not os.path.exists(".unused_cache")
    finally:
        server.shutdown()
        for e in engines:
            e.shutdown()
        server.server_close()


def test_prewarm_steps_and_refine():
    """--prewarm 2 3 warms one program per count and batch shape;
    --prewarm-refine adds the refine signatures, whose step counts stay."""
    server, engines, _ = cli_serve.build_server(_args(
        "--family", "both", "--port", "0", "--batch-sizes", "1,2", "--prewarm", "2", "3",
        "--prewarm-refine"))
    try:
        t2i, edit = engines
        # (2 counts + the refine program) x 2 batch shapes on each engine
        assert t2i.stats()["prewarmed"] == 6 and edit.stats()["prewarmed"] == 6
        assert t2i.batch_sizes == (1, 2) and edit.batch_sizes == (1, 2)
    finally:
        for e in engines:
            e.shutdown()
        server.server_close()


def test_quantize_bits_4_is_edit_only():
    with pytest.raises(SystemExit, match="edit-family option"):
        cli_serve.build_server(_args("--family", "sd", "--quantize", "--quantize-bits", "4"))
    server, engines, descs = cli_serve.build_server(_args(
        "--family", "edit", "--quantize", "--quantize-bits", "4", "--port", "0"))
    try:
        assert engines[0].pipeline.transformer.cfg.quant_int4
    finally:
        engines[0].shutdown()
        server.server_close()


def test_sigterm_routes_to_graceful_drain():
    old = signal.getsignal(signal.SIGTERM)
    try:
        cli_serve.install_sigterm_handler()
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not old
        with pytest.raises(KeyboardInterrupt):
            handler(signal.SIGTERM, None)
    finally:
        signal.signal(signal.SIGTERM, old)


def test_sigterm_drains_in_flight_requests_and_exits():
    """A server process stopped with SIGTERM while 3 requests wait in its
    batch window answers all 3 and exits 0; a request of another program,
    queued behind that batch, is answered with EngineShutDown (500)."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "consolver_torch", "serve", "--port", str(port), "--batch-size",
         "4", "--flush-ms", "1500", *CPU], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                _get(base, "/healthz", timeout=5)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.5)
        results = [None] * 3

        def client(i):
            results[i] = _post(base, "/v1/generate", {"prompt": f"p{i}", "seed": i,
                                                      "num_inference_steps": 2}, timeout=120)

        refused = []

        def queued_client():
            try:
                _post(base, "/v1/generate", {"prompt": "q", "num_inference_steps": 3},
                      timeout=120)
            except urllib.error.HTTPError as exc:
                refused.append((exc.code, json.load(exc)["error"]))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        while _get(base, "/v1/stats")["requests"] < 3:
            time.sleep(0.05)
        threads.append(threading.Thread(target=queued_client))
        threads[-1].start()
        while _get(base, "/v1/stats")["requests"] < 4:
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=120)
        assert proc.wait(timeout=120) == 0
        assert all(r is not None and _image(r).shape == (16, 16, 3) for r in results)
        assert len(refused) == 1 and refused[0][0] == 500
        assert refused[0][1].startswith("EngineShutDown")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_dispatches_and_prints_help(capsys):
    assert main(["serve", "--help"]) == 0
    assert "--family" in capsys.readouterr().out
