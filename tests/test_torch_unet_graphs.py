"""The UNet's CUDA graphs (``consolver_torch/models/graphs.py``) on the CPU:
who turns them on, and the wrapper's bookkeeping with a stub in place of
the CUDA capture.

Only a serving engine on a CUDA device with a UNet that is not
tensor-parallel turns the graphs on; a pipeline built outside an engine,
its copies and every CPU engine keep the eager forward.  With the capture
stubbed (a "graph" that reruns the body on its static inputs without
counting), the wrapper's rules are checked as the engine exercises them:
one ``model.unet.capture`` per signature, a ``model.unet.replay`` for every
later call, one ``model.unet.eager_fallback`` for a signature whose capture
raised, kernel launch counters that count the warm-up and each replay but
not the capture, answers equal to the eager forward's and never the graph's
own buffer.  The card tests (``tests/test_torch_cuda.py``) hold real
graphs to the eager forward bit for bit.
"""

import copy
import sys
import threading
import types

import numpy as np
import pytest
import torch

from consolver_torch.core import schedules
from consolver_torch.dist.tp import UNET_TP_RULES, is_sharded, shard_module_by_rules
from consolver_torch.kernels import flash_attention as fa
from consolver_torch.models import graphs
from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_torch.models.vae import AutoencoderKL, VaeConfig
from consolver_torch.pipelines.t2i import TextToImagePipeline
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
from consolver_torch.serve import GenerationRequest, InferenceEngine
from consolver_torch.serve.engine import unet_graphs_allowed

STEPS = 3
LATENT = 8
SPANS = ("model.unet.capture", "model.unet.replay", "model.unet.eager_fallback")


def _pipeline(seed=0):
    gen = torch.Generator().manual_seed(seed)
    models = [UNet2DCondition(UNetConfig.tiny(), device="cpu"),
              ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"),
              AutoencoderKL(VaeConfig.tiny(), device="cpu"),
              FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, num_actions=11, family="sd"),
                        device="cpu")]
    with torch.no_grad():
        for m in models:
            for p in m.parameters():
                p.normal_(0.0, 0.1, generator=gen)
    return TextToImagePipeline(*models[:3], schedules.DiffusionSchedule.sd15(),
                               factor_net=models[3], device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _req(i):
    return GenerationRequest(prompt=f"prompt {i}", seed=100 + i, num_inference_steps=STEPS)


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay reruns the captured
    body on the static inputs, with the launch counters left as they were
    (a real replay runs no Python)."""

    def __init__(self, body, inputs, flags, output):
        self.body, self.inputs, self.flags, self.output = body, inputs, flags, output

    def replay(self):
        counts = graphs.launch_counts()
        self.output.copy_(self.body(*self.inputs, *self.flags))
        graphs.set_launch_counts(counts)


def _stub_capture(monkeypatch, g, fail=lambda inputs: False):
    """Run ``g`` (a ``ForwardGraphs``) on the CPU with the capture stubbed;
    ``fail(inputs)`` makes a capture raise."""
    monkeypatch.setattr(g, "takes", lambda inputs: g.enabled and not torch.is_grad_enabled())
    monkeypatch.setattr(g, "_warm_up", lambda body, inputs, flags: body(*inputs, *flags))

    def record(body, inputs, flags):
        if fail(inputs):
            raise RuntimeError("operation not permitted when stream is capturing")
        static = [torch.zeros_like(x) for x in inputs]
        output = body(*static, *flags)  # the capture's wrapper calls
        return graphs._Graph(_StubGraph(body, static, flags, output), static, output)

    monkeypatch.setattr(g, "_record", record)


def _spans(stats):
    return {name: stats["spans"].get(name, {}).get("count", 0)
            for name in ("model.unet",) + SPANS}


# ------------------------------------------------------- who turns them on


def test_graphs_stay_off_outside_an_engine_and_in_copies():
    pipe = _pipeline()
    assert not pipe.unet.cuda_graphs.enabled
    pipe.unet.cuda_graphs.enabled = True
    # a copy holds other parameters: no graphs, off
    assert not copy.deepcopy(pipe.unet).cuda_graphs.enabled
    assert not pipe.quantize().unet.cuda_graphs.enabled
    assert not _pipeline().unet.cuda_graphs.enabled


def test_a_cpu_engine_keeps_the_eager_forward():
    pipe = _pipeline()
    with InferenceEngine(pipe, batch_size=2, batch_sizes=(1, 2), latent_size=LATENT) as eng:
        eng.generate(_req(0), timeout=120)
        stats = eng.stats()
    assert not pipe.unet.cuda_graphs.enabled and pipe.unet.cuda_graphs.signatures == {}
    counts = _spans(stats)
    assert counts["model.unet"] == STEPS and not any(counts[name] for name in SPANS)


@pytest.mark.parametrize("device,sharded,allowed", [
    ("cuda", False, True), ("cuda:0", False, True), ("cpu", False, False), ("cuda", True, False),
])
def test_unet_graphs_allowed(device, sharded, allowed):
    unet = UNet2DCondition(UNetConfig.tiny(), device="cpu")
    if sharded:  # the slicing needs only the mesh's size and rank
        shard_module_by_rules(types.SimpleNamespace(tp=2, model_rank=0), unet, UNET_TP_RULES)
    assert is_sharded(unet) is sharded
    assert unet_graphs_allowed(unet, torch.device(device)) is allowed


# ------------------------------------------------------ the wrapper's rules


def test_served_batches_capture_once_per_shape_then_replay(monkeypatch):
    """Shapes 1 and 2: prewarm captures each (program, shape) at its first
    UNet call and replays its other steps; every later batch replays all of
    its steps, and the images equal the eager engine's."""
    eager = _pipeline()
    with InferenceEngine(eager, batch_size=2, batch_sizes=(1, 2), latent_size=LATENT) as eng:
        want = [eng.generate(_req(i), timeout=120) for i in range(3)]
    pipe = _pipeline()
    g = pipe.unet.cuda_graphs
    _stub_capture(monkeypatch, g)
    with InferenceEngine(pipe, batch_size=2, batch_sizes=(1, 2), latent_size=LATENT) as eng:
        g.enabled = True  # as on a CUDA device
        assert eng.prewarm(_req(9)) == 2
        set_up = _spans(eng.stats())
        got = [eng.generate(_req(i), timeout=120) for i in range(3)]
        window = _spans(eng.stats())
    assert set_up == {"model.unet": 2 * STEPS, "model.unet.capture": 2,
                      "model.unet.replay": 2 * (STEPS - 1), "model.unet.eager_fallback": 0}
    delta = {name: window[name] - set_up[name] for name in window}
    assert delta == {"model.unet": 3 * STEPS, "model.unet.capture": 0,
                     "model.unet.replay": 3 * STEPS, "model.unet.eager_fallback": 0}
    assert list(g.signatures.values()) == [True, True]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_a_capture_that_raises_leaves_its_signature_eager(monkeypatch):
    pipe = _pipeline()
    g = pipe.unet.cuda_graphs
    # the shape-2 batch's UNet call (4 rows under CFG) cannot be captured
    _stub_capture(monkeypatch, g, fail=lambda inputs: inputs[0].shape[0] == 4)
    # a wide flush window, so that the two requests submitted at once share a batch
    with InferenceEngine(pipe, batch_size=2, batch_sizes=(1, 2), latent_size=LATENT,
                         flush_ms=500.0) as eng:
        g.enabled = True
        eng.prewarm(_req(9))
        futs = [eng.submit(_req(i)) for i in range(2)]
        images = [f.result(timeout=120) for f in futs]
        eng.generate(_req(5), timeout=120)
        counts = _spans(eng.stats())
    assert sorted(g.signatures.values()) == [False, True]
    assert counts["model.unet.eager_fallback"] == 1 and counts["model.unet.capture"] == 1
    # shape 1: prewarm's STEPS - 1 replays, then the lone request's STEPS
    assert counts["model.unet.replay"] == 2 * STEPS - 1
    assert all(im.ndim == 3 and im.dtype == np.uint8 for im in images)


def _counting_body(launches=3):
    """A forward that counts ``launches`` kernel #1 launches on the "mma"
    route, as the wrapper does, and doubles its input."""

    def body(x, flag):
        fa.flash_attention.launches += launches
        fa.flash_attention.launches_by_route["mma"] += launches
        return x * 2 + flag

    return body


def test_launch_counts_count_the_warm_up_and_each_replay_not_the_capture(monkeypatch):
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(fa.flash_attention, "launches_by_route", {"mma": 0, "fma": 0})
    g = graphs.ForwardGraphs("model.unet")
    _stub_capture(monkeypatch, g)
    g.enabled = True
    body, x = _counting_body(), torch.arange(4.0)
    with torch.no_grad():
        outs = [g(body, (x + i,), 1) for i in range(4)]
    assert fa.flash_attention.launches == 4 * 3
    assert fa.flash_attention.launches_by_route == {"mma": 12, "fma": 0}
    for i, out in enumerate(outs):
        torch.testing.assert_close(out, (x + i) * 2 + 1, rtol=0, atol=0)
    graph = g._graphs[next(iter(g._graphs))]
    assert graph.launches == {"flash_attention": 3, "flash_attention.mma": 3}
    # a fresh tensor each call, never the graph's buffer
    assert all(out.data_ptr() != graph.output.data_ptr() for out in outs)
    assert outs[-1].data_ptr() != outs[-2].data_ptr()


def test_signatures_split_by_shape_dtype_flags_and_inference_mode(monkeypatch):
    g = graphs.ForwardGraphs("model.unet")
    _stub_capture(monkeypatch, g)
    g.enabled = True
    body = _counting_body(0)
    with torch.no_grad():
        g(body, (torch.zeros(2),), 0)
        g(body, (torch.zeros(2),), 0)
        g(body, (torch.zeros(3),), 0)
        g(body, (torch.zeros(2, dtype=torch.float64),), 0)
        g(body, (torch.zeros(2),), 1)
    with torch.inference_mode():
        g(body, (torch.zeros(2),), 0)
    assert len(g.signatures) == 5
    g.clear()
    assert g.signatures == {}


def test_graphs_run_only_with_autograd_off_and_are_dropped_with_new_storage(monkeypatch):
    pipe = _pipeline()
    unet = pipe.unet
    g = unet.cuda_graphs
    _stub_capture(monkeypatch, g)
    g.enabled = True
    args = (torch.randn(2, LATENT, LATENT, 4), torch.tensor([10, 10]), torch.randn(2, 77, 32))
    unet(*args)  # autograd on: eager
    assert g.signatures == {}
    with torch.no_grad():
        want = unet(*args)
        got = unet(*args)
    assert len(g.signatures) == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    unet.float()  # parameters may move: the graphs go
    assert g.signatures == {}


def test_concurrent_callers_keep_exact_counts_and_answers(monkeypatch):
    """Threads replaying one model's graphs at once: each answer is its own
    input's, and the launch counters add up."""
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(fa.flash_attention, "launches_by_route", {"mma": 0, "fma": 0})
    g = graphs.ForwardGraphs("model.unet")
    _stub_capture(monkeypatch, g)
    g.enabled = True
    body = _counting_body(2)
    threads, calls, errors = 12, 200, []

    def caller(k):
        try:
            with torch.no_grad():
                for i in range(calls):
                    x = torch.full((k % 3 + 1,), float(k * 1000 + i))
                    out = g(body, (x,), 0)
                    if not torch.equal(out, x * 2):
                        errors.append((k, i))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=caller, args=(k,)) for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert errors == []
    assert fa.flash_attention.launches == threads * calls * 2
    assert len(g.signatures) == 3
