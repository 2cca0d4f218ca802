"""The port's span tracer (``consolver_torch/utils/profiling.py``), the spans
the serving path and the pipelines open, and the benchmark's readers of
them (``perfbench/metrics/*``, program spans), on the tiny stacks.

The CPU tests pin the tracer's arithmetic (nesting, self and blocked time
under a fake clock, threads kept apart, exact totals under concurrent
spans), that a ``record_function`` range opens only while a profiler
records, the spans of one engine batch and one HTTP round trip, the rings
the benchmark reads, and each reader on synthetic engine stats.  The two
card tests (marker ``cuda``) check that the ``host.sync`` counter misses no
synchronising call of a denoise step, and that the spans land on the
profiler's clock beside the kernels they launched:

    python -m pytest tests/test_torch_tracing.py -m cuda -q
"""

import base64
import contextlib
import copy
import http.client
import importlib.util
import io
import json
import sys
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from consolver_torch.core import schedules
from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_torch.models.flux import FluxConfig, FluxTransformer
from consolver_torch.models.t5 import T5Config, T5Encoder
from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_torch.models.vae import AutoencoderKL, VaeConfig
from consolver_torch.pipelines.edit import FluxKontextPipeline
from consolver_torch.pipelines.t2i import TextToImagePipeline
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
from consolver_torch.serve import (
    EditInferenceEngine,
    EditRequest,
    GenerationRequest,
    InferenceEngine,
    ReplicaGroup,
    make_server,
)
from consolver_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
LATENT = 8
STEPS = 8
SD_POLICY = FactorNetConfig(order_dim=2, scaler_dim=0, num_actions=11, family="sd")
# host.sync spans inside one step of the learnable SD loop: the copies of
# the policy's timestep pair and of alpha-bar's t, t_prev and final value,
# and alpha-bar's two reads at a 0-dim index
SYNCS_PER_SD_STEP = 6


def _fill(module, gen, std=0.1):
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, std, generator=gen)
    return module


def _sd_models(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [_fill(m, gen) for m in (
        UNet2DCondition(UNetConfig.tiny(), device="cpu"),
        ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"),
        AutoencoderKL(VaeConfig.tiny(), device="cpu"),
        FactorNet(SD_POLICY, device="cpu"))]


def _sd_pipeline(device="cpu", seed=0):
    unet, text, vae, net = (copy.deepcopy(m).to(device) for m in _sd_models(seed))
    return TextToImagePipeline(unet, text, vae, schedules.DiffusionSchedule.sd15(),
                               factor_net=net, device=device)


def _flux_pipeline(device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    fcfg = FluxConfig.tiny()
    models = [
        FluxTransformer(fcfg, device="cpu"),
        T5Encoder(T5Config(vocab_size=64, d_model=fcfg.joint_text_dim, d_kv=8, d_ff=64,
                           num_layers=1, num_heads=4), device="cpu"),
        ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=fcfg.pooled_text_dim,
                                       num_layers=1, num_heads=2, intermediate_size=32),
                        device="cpu"),
        AutoencoderKL(VaeConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                                latent_channels=4), device="cpu"),
        FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11,
                                  family="fm"), device="cpu"),
    ]
    models = [_fill(m, gen).to(device) for m in models]
    return FluxKontextPipeline(*models[:4], factor_net=models[4], device=device)


EDIT_KW = dict(resolution=16, t5_max_length=4, clip_max_length=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sd_pipe():
    return _sd_pipeline()


@pytest.fixture
def totals():
    """Fresh totals active on the test's thread."""
    t = profiling.SpanTotals()
    with profiling.use(t):
        yield t


class _FakeClock:
    def __init__(self):
        self.now = 0

    def monotonic_ns(self):
        return self.now


def _req(i, steps=STEPS):
    return GenerationRequest(prompt=f"prompt {i}", seed=100 + i, num_inference_steps=steps)


def _edit_req(i):
    image = np.random.default_rng(i).integers(0, 256, (24, 20, 3), np.uint8)
    return EditRequest(instruction=f"edit {i}", image=image, seed=200 + i, num_inference_steps=2)


# ------------------------------------------------------------------ tracer


def _open_spans():
    """The names of the spans open on this thread, outermost first."""
    return tuple(s.name for s in profiling._thread.stack)


def test_nesting_self_and_blocked_time_under_a_fake_clock(monkeypatch, totals):
    clock = _FakeClock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.span("outer") as outer:  # 0 .. 100
        clock.now = 10
        with profiling.span("child"):  # 10 .. 50
            clock.now = 20
            with profiling.host_sync():  # 20 .. 35
                assert _open_spans() == ("outer", "child", "host.sync")
                clock.now = 35
            clock.now = 50
        clock.now = 60
        with profiling.host_sync():  # 60 .. 64
            clock.now = 64
        clock.now = 100
    assert (outer.start_ns, outer.ns) == (0, 100) and _open_spans() == ()
    snap = totals.snapshot()
    assert snap["outer"] == {"count": 1, "total_ms": 100e-6, "self_ms": 56e-6,
                             "blocked_ms": 19e-6}
    assert snap["child"] == {"count": 1, "total_ms": 40e-6, "self_ms": 25e-6,
                             "blocked_ms": 15e-6}
    assert snap["host.sync"] == {"count": 2, "total_ms": 19e-6, "self_ms": 19e-6,
                                 "blocked_ms": 19e-6}
    totals.record("engine.queue", 1_000, 4_000)  # a pair of stamps: no children
    assert totals.snapshot()["engine.queue"] == {"count": 1, "total_ms": 3e-3, "self_ms": 3e-3,
                                                 "blocked_ms": 0.0}


def test_spans_of_one_thread_never_nest_in_another_threads(totals):
    other = profiling.SpanTotals()
    opened, closed = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with profiling.use(other):
            opened.wait(10)
            with profiling.span("b"):
                seen["open"] = _open_spans()
                with profiling.host_sync():
                    pass
        closed.set()

    t = threading.Thread(target=worker)
    t.start()
    with profiling.span("a"):
        opened.set()
        assert closed.wait(10)
    t.join(10)
    assert not t.is_alive() and seen["open"] == ("b",)
    a, b = totals.snapshot()["a"], other.snapshot()["b"]
    assert set(totals.snapshot()) == {"a"} and set(other.snapshot()) == {"b", "host.sync"}
    assert a["self_ms"] == a["total_ms"] and a["blocked_ms"] == 0  # b is not a child of a
    assert b["blocked_ms"] > 0


def test_a_thread_without_totals_of_its_own_adds_to_the_default():
    def probe():
        with profiling.span("tracing.default_probe"):
            pass

    before = profiling.DEFAULT.snapshot().get("tracing.default_probe", {"count": 0})["count"]
    t = threading.Thread(target=probe)
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert profiling.DEFAULT.snapshot()["tracing.default_probe"]["count"] == before + 1


def test_totals_exact_under_concurrent_spans(totals):
    """More threads than cores, a short switch interval: every span's own
    duration is in the totals, none lost and none counted twice."""
    n_threads, n_spans = 16, 400
    durations = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def worker(k):
        with profiling.use(totals):
            start.wait(30)
            for _ in range(n_spans):
                with profiling.span("outer") as s:
                    with profiling.host_sync():
                        pass
                durations[k].append(s.ns)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = totals.snapshot()
    assert snap["outer"]["count"] == snap["host.sync"]["count"] == n_threads * n_spans
    assert snap["outer"]["total_ms"] * 1e6 == pytest.approx(sum(map(sum, durations)), abs=0.5)
    assert snap["outer"]["blocked_ms"] == pytest.approx(snap["host.sync"]["total_ms"], abs=1e-6)
    merged = profiling.merge([snap, snap])
    assert merged["outer"]["count"] == 2 * n_threads * n_spans


def test_to_device_counts_copies_from_host_memory_only(totals):
    t = profiling.to_device([1.0, 2.0], "cpu", torch.float32)
    assert t.dtype == torch.float32 and t.tolist() == [1.0, 2.0]
    assert profiling.to_device(np.arange(3), torch.device("cpu")).tolist() == [0, 1, 2]
    assert totals.snapshot()["host.sync"]["count"] == 2
    same = profiling.to_device(t, "cpu")  # already on the device: no copy, no span
    assert same is t and totals.snapshot()["host.sync"]["count"] == 2


def test_no_range_opens_while_no_profiler_records(monkeypatch, totals):
    opened = []

    class _Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", _Range)
    assert not profiling.profiler_recording()
    for i in range(5):
        with profiling.span("pipeline.step", i):
            pass
    assert opened == [] and totals.snapshot()["pipeline.step"]["count"] == 5
    monkeypatch.setattr(profiling._autograd_profiler, "_is_profiler_enabled", True)
    with profiling.span("pipeline.step", 7), profiling.span("model.unet"):
        pass
    assert opened == ["pipeline.step#7", "model.unet"]


def test_tags_are_formatted_only_while_a_profiler_records(monkeypatch, totals):
    formatted = []

    class _Id:
        def __str__(self):
            formatted.append(1)
            return "40"

    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    with profiling.span("engine.batch", (12, [_Id(), 41])):
        pass
    assert formatted == []
    assert profiling._label((12, [_Id(), 41])) == "12:40,41" and formatted == [1]
    assert profiling._label(7) == "7" and profiling._label((3, [])) == "3:"


def _all_threads_profile():
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def test_one_range_per_span_in_the_chrome_trace_on_every_thread(tmp_path, totals):
    """Under the benchmark's profiler settings (every thread recorded) the
    gate holds on a thread that did not start the profiler, and each span
    is one ``user_annotation`` range on its own thread, tagged after '#'."""
    seen = {}

    def worker():
        seen["recording"] = profiling.profiler_recording()
        seen["tid"] = threading.get_native_id()
        with profiling.span("engine.batch", (3, [1, 2])):
            for i in range(2):
                with profiling.span("pipeline.step", i), profiling.host_sync():
                    torch.ones(4).sum()

    with _all_threads_profile() as prof:
        t = threading.Thread(target=worker)
        t.start()
        t.join(30)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    assert seen["recording"]
    assert sorted(e["name"] for e in ranges) == [
        "engine.batch#3:1,2", "host.sync", "host.sync", "pipeline.step#0", "pipeline.step#1"]
    assert {e["tid"] for e in ranges} == {seen["tid"]}
    batch = next(e for e in ranges if e["name"].startswith("engine.batch"))
    for e in ranges:
        assert batch["ts"] <= e["ts"] and e["ts"] + e["dur"] <= batch["ts"] + batch["dur"]


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path, totals):
    with profiling.trace(None):  # no directory: a no-op
        with profiling.span("pipeline.text"):
            pass
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("pipeline.decode", 4):
            torch.ones(8).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "pipeline.decode#4" in names and "pipeline.text" not in names
    assert totals.snapshot()["pipeline.decode"]["count"] == 1


# ------------------------------------------------------------- the program


def _worker_ranges(events):
    """The engine worker's ranges: the thread that ran ``engine.batch``."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    tid = next(e["tid"] for e in ranges if e["name"].startswith("engine.batch"))
    return [e for e in ranges if e["tid"] == tid]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_one_preview_batch_nests_its_steps_in_one_engine_batch(sd_pipe, tmp_path):
    """An 8-step preview: 8 ``pipeline.step`` ranges, each holding one UNet
    call, one policy span and the expected ``host.sync`` count, inside one
    ``engine.batch`` on the worker thread; and the same counts in the
    engine's totals."""
    with InferenceEngine(sd_pipe, batch_size=2, latent_size=LATENT, flush_ms=10.0) as eng:
        with profiling.trace(str(tmp_path)):
            img = eng.generate(_req(0), timeout=300, request_id=41)
        spans = eng.stats()["spans"]
    assert img.shape == (16, 16, 3)
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())["traceEvents"]
    ranges = _worker_ranges(events)
    batches = [e for e in ranges if e["name"].startswith("engine.batch#")]
    steps = sorted((e for e in ranges if e["name"].startswith("pipeline.step#")),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in batches] == ["engine.batch#0:41"]
    assert [e["name"] for e in steps] == [f"pipeline.step#{i}" for i in range(STEPS)]
    for step in steps:
        assert _inside(step, batches[0])
        inner = [e["name"] for e in ranges if e is not step and _inside(e, step)]
        assert sorted(inner) == sorted(["model.unet#4", "pipeline.policy"]
                                       + ["host.sync"] * SYNCS_PER_SD_STEP)
    for name in ("engine.prep", "pipeline.text", "pipeline.decode"):
        assert sum(e["name"] == name and _inside(e, batches[0]) for e in ranges) == 1
    assert spans["engine.batch"]["count"] == spans["engine.queue"]["count"] == 1
    assert spans["pipeline.step"]["count"] == spans["model.unet"]["count"] == STEPS
    assert spans["pipeline.step"]["blocked_ms"] > 0 and spans["engine.fetch"]["count"] == 1
    # the batch's own set-up copies (the prompt ids, the empty prompt's ids,
    # alpha-bar) are host.sync spans outside the steps
    assert spans["host.sync"]["count"] == STEPS * SYNCS_PER_SD_STEP + 3


def test_rings_keep_one_entry_per_request_and_batch_from_the_spans_stamps(sd_pipe):
    with InferenceEngine(sd_pipe, batch_size=4, latent_size=LATENT, flush_ms=300.0) as eng:
        futs = [eng.submit(_req(i, steps=2)) for i in range(3)]
        for f in futs:
            f.result(timeout=300)
        eng.generate(_req(9, steps=2), timeout=300)
        waits, dispatches = list(eng._wait_ms), list(eng._dispatch_ms)
        stats = eng.stats()
    assert len(waits) == 4 and len(dispatches) == 2 and stats["batches"] == 2
    assert eng._wait_ms.maxlen == eng._dispatch_ms.maxlen == 512
    spans = stats["spans"]
    assert spans["engine.queue"]["count"] == 4 and spans["engine.batch"]["count"] == 2
    assert spans["engine.queue"]["total_ms"] == pytest.approx(sum(waits), rel=1e-9)
    assert spans["engine.batch"]["total_ms"] == pytest.approx(sum(dispatches), rel=1e-9)


def _post(base, path, payload):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def _closed_spans(eng, name, count, timeout=30.0):
    """The engine's spans once ``count`` spans ``name`` closed: a handler
    closes ``serve.request`` after the client has its answer."""
    deadline = time.monotonic() + timeout
    while True:
        spans = eng.stats()["spans"]
        if spans.get(name, {}).get("count", 0) >= count or time.monotonic() > deadline:
            return spans
        time.sleep(0.01)


def _serve(eng=None, edit=None):
    server = make_server(eng, host="127.0.0.1", port=0, edit_engine=edit)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


def test_http_round_trip_spans_in_the_stats(sd_pipe):
    eng = InferenceEngine(sd_pipe, batch_size=2, latent_size=LATENT, flush_ms=10.0)
    server, base = _serve(eng)
    try:
        _post(base, "/v1/generate", {"prompt": "a corgi", "seed": 7, "num_inference_steps": 2})
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            served = json.load(r)["spans"]  # what the handler closed before it answered
        conn = http.client.HTTPConnection(*server.server_address[:2], timeout=30)
        conn.request("POST", "/v1/nothing", body=b"{}")
        assert conn.getresponse().status == 404
        conn.close()
        spans = _closed_spans(eng, "serve.request", 1)
    finally:
        server.shutdown()
        server.server_close()
        eng.shutdown()
    for name in ("serve.engine_wait", "serve.png_encode", "engine.queue", "engine.batch"):
        assert served[name]["count"] == 1, name
    for name in ("serve.request", "serve.engine_wait", "serve.png_encode", "engine.queue",
                 "engine.batch"):
        assert spans[name]["count"] == 1, name
    assert "serve.png_decode" not in spans  # a preview has no source
    req = spans["serve.request"]
    assert req["total_ms"] >= spans["serve.engine_wait"]["total_ms"] + spans["serve.png_encode"][
        "total_ms"]
    assert req["self_ms"] == pytest.approx(
        req["total_ms"] - spans["serve.engine_wait"]["total_ms"]
        - spans["serve.png_encode"]["total_ms"], abs=1e-6)
    assert eng.stats()["spans"]["serve.request"]["count"] == 1  # the 404 opened none


def test_edit_round_trip_records_the_source_decode():
    eng = EditInferenceEngine(_flux_pipeline(), batch_size=1, flush_ms=10.0, **EDIT_KW)
    server, base = _serve(edit=eng)
    try:
        buf = io.BytesIO()
        Image.fromarray(_edit_req(0).image).save(buf, format="PNG")
        _post(base, "/v1/edit", {"instruction": "make it red", "num_inference_steps": 2,
                                 "image_png_b64": base64.b64encode(buf.getvalue()).decode()})
        spans = _closed_spans(eng, "serve.request", 1)
    finally:
        server.shutdown()
        server.server_close()
        eng.shutdown()
    for name in ("serve.request", "serve.png_decode", "serve.png_encode", "engine.prep",
                 "engine.resize", "pipeline.text", "pipeline.vae_encode", "pipeline.decode"):
        assert spans[name]["count"] == 1, name
    assert spans["engine.prep"]["self_ms"] < spans["engine.prep"]["total_ms"]  # the resize inside
    assert spans["pipeline.step"]["count"] == spans["model.dit"]["count"] == 2
    assert spans["pipeline.policy"]["count"] == 2


def test_replica_group_sums_the_replicas_spans(sd_pipe):
    engines = [InferenceEngine(sd_pipe, batch_size=1, latent_size=LATENT, flush_ms=1.0)
               for _ in range(2)]
    with ReplicaGroup(engines) as group:
        futs = [group.submit(_req(i, steps=2), request_id=i) for i in range(2)]
        for f in futs:
            f.result(timeout=300)
        with profiling.use(group.spans), profiling.span("serve.request"):
            pass
        spans = group.stats()["spans"]
    assert [e.stats()["spans"]["engine.batch"]["count"] for e in engines] == [1, 1]
    assert spans["engine.batch"]["count"] == 2 and spans["pipeline.step"]["count"] == 4
    assert spans["serve.request"]["count"] == 1


# ------------------------------------------------------------ the readers

READERS = ["pipeline.step_host_ms.preview", "pipeline.step_host_ms.edit",
           "pipeline.step_blocked_ms.preview", "pipeline.step_blocked_ms.edit",
           "serve.codec_ms.preview", "serve.codec_ms.edit", "serve.prep_ms.edit"]


def _reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _row(count, total, blocked=0.0):
    return {"count": count, "total_ms": total, "self_ms": total, "blocked_ms": blocked}


BEFORE = {"pipeline.step": _row(16, 800.0, 500.0), "serve.request": _row(2, 900.0),
          "serve.png_encode": _row(2, 40.0), "serve.png_decode": _row(1, 30.0),
          "engine.prep": _row(2, 100.0)}
AFTER = {"pipeline.step": _row(56, 3800.0, 2700.0), "serve.request": _row(7, 4000.0),
         "serve.png_encode": _row(7, 140.0), "serve.png_decode": _row(6, 280.0),
         "engine.prep": _row(7, 600.0), "host.sync": _row(200, 3000.0, 3000.0)}


@pytest.mark.parametrize("name,expected", [
    ("pipeline.step_host_ms.preview", (3000.0 - 2200.0) / 40),
    ("pipeline.step_host_ms.edit", (3000.0 - 2200.0) / 40),
    ("pipeline.step_blocked_ms.preview", 2200.0 / 40),
    ("pipeline.step_blocked_ms.edit", 2200.0 / 40),
    ("serve.codec_ms.preview", (100.0 + 250.0) / 5),
    ("serve.codec_ms.edit", (100.0 + 250.0) / 5),
    ("serve.prep_ms.edit", 500.0 / 5),
])
def test_reader_on_synthetic_stats(name, expected):
    read = _reader(name)
    rec = {"stats_before": {"completed": 2, "spans": BEFORE},
           "stats_after": {"completed": 7, "spans": AFTER}}
    assert read(rec) == pytest.approx(expected)
    # a program without spans (an older commit) and a window without the
    # span read nothing, and raise nothing
    assert read({"stats_before": {"completed": 2}, "stats_after": {"completed": 7}}) is None
    assert read({"stats_before": {"spans": AFTER}, "stats_after": {"spans": AFTER}}) is None
    # spans new in the window (none before it) count from zero
    assert read({"stats_before": {}, "stats_after": {"spans": AFTER}}) is not None


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sync_warnings(fn):
    """Run ``fn`` with CUDA's sync debug mode on: (message, spans open on
    this thread) for each synchronising call it makes."""
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        seen.append((str(message), _open_spans(), f"{filename}:{lineno}"))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's one notice that it is a prototype, raised where it is set, is no sync
    return [s for s in seen if "called a synchronizing CUDA operation" in s[0]]


@pytest.mark.cuda
def test_every_sync_of_a_denoise_step_is_counted(cuda):
    """One step of the learnable SD loop and of the FM loop, with their
    per-batch set-up: every call that CUDA's sync debug mode flags runs
    inside a ``host.sync`` span."""
    sd = _sd_pipeline(cuda)
    flux = _flux_pipeline(cuda)
    ids = np.arange(2 * 77).reshape(2, 77) % 40
    noise = torch.randn((2, LATENT, LATENT, 4))
    ref = torch.rand((1, 16, 16, 3)) * 2 - 1
    fnoise = torch.randn((1, LATENT, LATENT, 4))

    def t2i():
        sd(torch.Generator(cuda).manual_seed(0), ids, noise, num_inference_steps=1, decode=False,
           record=False)

    def fm():
        flux.rollout(torch.Generator(cuda).manual_seed(0), ids[:1, :4], ids[:1, :4], ref, fnoise,
                     num_inference_steps=1, decode=False, record=False)

    for fn in (t2i, fm):
        with torch.inference_mode():
            fn()  # the first call builds the kernels and picks algorithms
            flagged = _sync_warnings(fn)
        assert flagged, "the sync debug mode flagged nothing: the check would be vacuous"
        missed = [(msg, where) for msg, open_, where in flagged if "host.sync" not in open_]
        assert not missed, missed


@pytest.mark.cuda
def test_spans_share_the_device_traces_clock(cuda, tmp_path):
    """In a trace of one served batch on the card, the kernels that a
    ``pipeline.step`` range on the worker thread launched (by correlation
    id) start after the range starts, and those launched before the step's
    last ``host.sync`` (which waits for them) end before that sync does."""
    slack_us = 50.0  # the profiler's conversion of device stamps to the host clock
    with InferenceEngine(_sd_pipeline(cuda), batch_size=2, latent_size=LATENT,
                         flush_ms=10.0) as eng:
        eng.generate(_req(0), timeout=300)  # builds the kernels
        with profiling.trace(str(tmp_path)):
            eng.generate(_req(1), timeout=300, request_id=5)
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())["traceEvents"]
    ranges = _worker_ranges(events)
    tid = ranges[0]["tid"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and e.get("tid") == tid
                and "correlation" in (e.get("args") or {})}
    kernels = [(launches[e["args"]["correlation"]], e) for e in events
               if e.get("cat") == "kernel" and e["args"].get("correlation") in launches]
    steps = [e for e in ranges if e["name"].startswith("pipeline.step#")]
    assert len(steps) == STEPS
    for step in steps:
        syncs = [e for e in ranges if e["name"] == "host.sync" and _inside(e, step)]
        last = max(syncs, key=lambda e: e["ts"])
        mine = [(ts, k) for ts, k in kernels if step["ts"] <= ts <= step["ts"] + step["dur"]]
        assert mine, step["name"]
        for ts, k in mine:
            assert k["ts"] >= step["ts"] - slack_us
            if ts < last["ts"]:
                assert k["ts"] + k["dur"] <= last["ts"] + last["dur"] + slack_us
