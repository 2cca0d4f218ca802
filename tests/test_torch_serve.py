"""consolver_torch's serving engines and HTTP front-end on the tiny stacks on
the CPU: the cases of ``tests/test_serve.py`` that apply to one process
without a mesh and without the CLI, against the port's engines.

The engine's determinism contract: a request's image depends only on its
own (prompt, seed, program key), never on which other requests shared its
batch, because its noise comes from its seed and every model op is per
sample.  These tests pin that, the batching and padding accounting,
program-key isolation, the hot reload and the HTTP surface.  Added here:
the uint8 conversion bit-equal to the JAX package's (ties included), a hot
reload that must not reuse the old denoise cache, and a mesh whose data axis
does not divide the batch raising.
"""

import base64
import copy
import dataclasses
import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
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
from consolver_torch.pipelines.base import Pipeline
from consolver_torch.pipelines.edit import FluxKontextPipeline
from consolver_torch.pipelines.t2i import TextToImagePipeline
from consolver_torch.policy import io as policy_io
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
from consolver_torch.serve import (
    EditInferenceEngine,
    EditRequest,
    EngineShutDown,
    GenerationRequest,
    InferenceEngine,
    RequestExpired,
    SD3InferenceEngine,
    make_replicas,
    make_server,
)
from consolver_torch.dist.mesh import Mesh
from consolver_torch.serve import engine as tengine
from consolver_torch.serve.http import MAX_BODY_BYTES, MAX_EDIT_PIXELS, _decode_image_b64
from consolver_tpu.serve import engine as jengine

BATCH = 4
LATENT = 8
IMG = LATENT * 2  # the tiny VAE has 2 levels: a 2x upscale
SHAPE = (IMG, IMG, 3)
SD_POLICY = FactorNetConfig(order_dim=2, scaler_dim=0, num_actions=11, family="sd")


def _fill(module, gen, std=0.1):
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, std, generator=gen)
    return module


def _sd_pipeline(factor_net=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return TextToImagePipeline(
        _fill(UNet2DCondition(UNetConfig.tiny(), device="cpu"), gen),
        _fill(ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"), gen),
        _fill(AutoencoderKL(VaeConfig.tiny(), device="cpu"), gen),
        schedules.DiffusionSchedule.sd15(), factor_net=factor_net, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny stacks' ops are too small to split, and
    the suite's workers share the host's cores; with the default count a
    program's run time, which the prewarm budget and flush-window tests
    measure against, swings with the host's load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipeline():
    return _sd_pipeline()


@pytest.fixture(scope="module")
def policy_pipeline():
    torch.manual_seed(3)
    return _sd_pipeline(FactorNet(SD_POLICY, device="cpu"), seed=1)


@pytest.fixture()
def engine(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, latent_size=LATENT, flush_ms=150.0)
    yield eng
    eng.shutdown()


def _req(i, **kw):
    kw.setdefault("num_inference_steps", 2)
    return GenerationRequest(prompt=f"prompt {i}", seed=100 + i, **kw)


def _serve(eng=None, edit=None):
    server = make_server(eng, port=0, edit_engine=edit)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


def _post(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _post_code(url, payload, timeout=60):
    try:
        _post(url, payload, timeout)
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()
    return 200, ""


def _png_of(payload):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(payload["image_png_b64"]))))


# ------------------------------------------------------------- the engine


def test_uint8_conversion_matches_jax():
    """Round half to even on both sides, ties at every .5 level included."""
    levels = np.arange(256, dtype=np.float32)
    x = np.concatenate([
        (levels + 0.5) / 255, levels / 255, np.nextafter((levels + 0.5) / 255, 0),
        np.array([-0.3, 1.7, 0.0, 1.0, np.float32(127.5 / 255)], np.float32),
        np.random.default_rng(0).uniform(-0.1, 1.1, 4096).astype(np.float32),
    ]).astype(np.float32)
    want = np.asarray(jengine._uint8_in_program(jnp.asarray(x)))
    got = tengine._uint8_in_program(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_seed_noise_is_a_function_of_the_seed():
    a = tengine.seed_noise([5, 6, 5], (2, 2, 4))
    assert a.dtype == torch.float32 and a.shape == (3, 2, 2, 4)
    assert torch.equal(a[0], a[2]) and not torch.equal(a[0], a[1])
    assert torch.equal(tengine.seed_noise([6], (2, 2, 4))[0], a[1])


def test_mesh_raises_naming_the_roadmap_item(pipeline):
    """Mesh serving landed (ROADMAP A.15); what still raises is a batch
    shape that does not divide by the mesh's data ranks (checked before any
    collective, so a mesh without process groups shows it)."""
    mesh = Mesh(rank=0, world=2, dp=2, tp=1, data_rank=0, model_rank=0, data_group=None,
                model_group=None, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="divide"):
        InferenceEngine(pipeline, batch_size=3, latent_size=LATENT, mesh=mesh)


def test_prewarm_compiles_one_program_per_signature(engine):
    """prewarm dedupes by program_key and leaves the denoise function in the
    pipeline cache, so the first real request finds it."""
    n = engine.prewarm(_req(0), _req(1), _req(2, num_inference_steps=3), timeout=300)
    assert n == 2  # two distinct (steps, cfg, solver, det) signatures
    cache_keys = set(engine.pipeline.programs)  # (steps, cfg, solver, record, deterministic)
    assert (2, 3.0, "consistencysolver", False, False) in cache_keys
    assert (3, 3.0, "consistencysolver", False, False) in cache_keys
    assert engine.stats()["prewarmed"] == 2
    before = engine.stats()["batches"]
    img = engine.generate(_req(5), timeout=300)
    assert img.shape == SHAPE
    assert engine.stats()["batches"] == before + 1


def test_single_request_pads_and_serves(engine):
    img = engine.generate(_req(0), timeout=300)
    assert img.shape == SHAPE and img.dtype == np.uint8
    s = engine.stats()
    assert s["batches"] == 1 and s["batched_rows"] == 1
    assert s["padded_rows"] == BATCH - 1 and s["completed"] == 1


def test_batched_result_identical_to_solo(engine):
    """Bit-identical pixels whether a request rides alone or packed."""
    solo = engine.generate(_req(0), timeout=300)
    futs = [engine.submit(_req(i)) for i in range(BATCH)]
    packed = [f.result(timeout=300) for f in futs]
    np.testing.assert_array_equal(solo, packed[0])
    s = engine.stats()
    assert s["batches"] == 2 and s["batched_rows"] == 1 + BATCH
    assert s["mean_batch_occupancy"] == pytest.approx((1 + BATCH) / (2 * BATCH))
    assert any(not np.array_equal(packed[0], p) for p in packed[1:])


def test_program_keys_never_mix(engine):
    futs = [engine.submit(_req(i)) for i in range(2)]
    futs += [engine.submit(_req(i, num_inference_steps=3)) for i in range(2)]
    imgs = [f.result(timeout=300) for f in futs]
    assert all(im.shape == SHAPE for im in imgs)
    s = engine.stats()
    assert s["batches"] == 2 and s["batched_rows"] == 4
    assert not np.array_equal(imgs[0], imgs[2])  # same seed, other step count


def test_solver_zoo_requests_serve(engine):
    imgs = {name: engine.generate(_req(0, solver=name), timeout=300)
            for name in ("ddim", "multistep-dpm", "sde-dpmsolver++")}
    assert all(img.shape == SHAPE for img in imgs.values())
    assert not np.array_equal(imgs["ddim"], imgs["multistep-dpm"])


def test_engine_error_propagates_and_engine_survives(engine):
    bad = GenerationRequest(prompt="x", num_inference_steps=2, solver="no-such-solver")
    with pytest.raises(ValueError, match="Unknown solver"):
        engine.generate(bad, timeout=300)
    amed = GenerationRequest(prompt="x", num_inference_steps=5, solver="amed")
    with pytest.raises(ValueError, match="AMED"):  # only published step counts
        engine.generate(amed, timeout=300)
    assert engine.stats()["errors"] == 2
    assert engine.generate(_req(1), timeout=300).shape == SHAPE


def test_shutdown_fails_queued_requests(pipeline):
    eng = InferenceEngine(pipeline, batch_size=2, latent_size=LATENT, flush_ms=10.0)
    eng.generate(_req(0), timeout=300)
    eng.shutdown()
    with pytest.raises(EngineShutDown):
        eng.submit(_req(1))


def test_stats_latency_percentiles(engine):
    engine.generate(_req(0), timeout=300)
    engine.generate(_req(1), timeout=300)
    s = engine.stats()
    assert s["execute_ms_p50"] > 0 and s["execute_ms_p95"] >= s["execute_ms_p50"]
    assert s["queue_wait_ms_p50"] >= 0 and s["dispatch_ms_p50"] > 0


def test_zoo_solver_deterministic_does_not_fork_programs():
    a = GenerationRequest(prompt="x", solver="dpmsolver", deterministic=True)
    b = GenerationRequest(prompt="x", solver="dpmsolver", deterministic=False)
    assert a.program_key == b.program_key
    c = GenerationRequest(prompt="x", deterministic=True)  # learnable
    d = GenerationRequest(prompt="x", deterministic=False)
    assert c.program_key != d.program_key
    e = EditRequest(instruction="x", image=np.zeros((4, 4, 3), np.uint8), solver="euler",
                    deterministic=True)
    f = EditRequest(instruction="x", image=np.zeros((4, 4, 3), np.uint8), solver="euler")
    assert e.program_key == f.program_key
    for req in (a, c, e):  # the same keys as the JAX package's
        jcls = jengine.EditRequest if isinstance(req, EditRequest) else jengine.GenerationRequest
        assert jcls(**dataclasses.asdict(req)).program_key == req.program_key


def test_padded_serving_one_program_many_step_counts(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, latent_size=LATENT, flush_ms=50.0,
                          padded_max_steps=4)
    try:
        img2 = eng.generate(_req(0, num_inference_steps=2), timeout=300)
        img3 = eng.generate(_req(0, num_inference_steps=3), timeout=300)
        padded_keys = [k for k in eng.pipeline.programs if k[0] == "padded"]
        assert len(padded_keys) == 1  # one program served both counts
        assert not np.array_equal(img2, img3)
    finally:
        eng.shutdown()
    with InferenceEngine(pipeline, batch_size=BATCH, latent_size=LATENT,
                         flush_ms=50.0) as per_count:
        np.testing.assert_array_equal(img2, per_count.generate(_req(0, num_inference_steps=2),
                                                               timeout=300))
        np.testing.assert_array_equal(img3, per_count.generate(_req(0, num_inference_steps=3),
                                                               timeout=300))


# ---------------------------------------------------------------- policy


def test_deterministic_policy_is_slot_independent(policy_pipeline):
    eng = InferenceEngine(policy_pipeline, batch_size=BATCH, latent_size=LATENT, flush_ms=150.0)
    try:
        req = _req(0, deterministic=True)
        solo = eng.generate(req, timeout=300)
        futs = [eng.submit(_req(i + 10, deterministic=True)) for i in range(2)]
        futs.append(eng.submit(req))  # slot 2 of a full batch
        futs.append(eng.submit(_req(13, deterministic=True)))
        packed = [f.result(timeout=300) for f in futs]
        np.testing.assert_array_equal(solo, packed[2])
        # deterministic and sampled share neither program nor batch
        assert eng.generate(_req(0), timeout=300).shape == SHAPE
        assert eng.stats()["batches"] == 3
    finally:
        eng.shutdown()


def test_mode_action_matches_argmax(policy_pipeline):
    fnet = copy.deepcopy(policy_pipeline.factor_net)
    gen = torch.Generator().manual_seed(0)
    _fill(fnet, gen, 0.3)
    conds = {"x": torch.randn((2, fnet.config.input_dim), generator=gen)}
    with torch.no_grad():
        values, probs = fnet.mode_action(conds)
        logp = fnet.log_probs(conds)
    idx = logp.argmax(dim=-1)
    expect = fnet.action_values[torch.arange(fnet.config.action_dims)[None, :], idx]
    assert torch.equal(values, expect)
    assert float(probs.min()) > 0.0
    torch.testing.assert_close(probs, logp.exp().amax(-1), rtol=1e-6, atol=0)


# ------------------------------------------------------------------ edit


def _tiny_flux_pipeline(seed=0):
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
    ]
    policy = FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11,
                                       family="fm"), device="cpu")
    for m in models + [policy]:
        _fill(m, gen, 0.1)
    return FluxKontextPipeline(*models, factor_net=policy, device="cpu")


@pytest.fixture(scope="module")
def edit_pipe():
    return _tiny_flux_pipeline()


EDIT_KW = dict(resolution=16, t5_max_length=4, clip_max_length=4)  # 2-level VAE x 2x2 packing


@pytest.fixture(scope="module")
def edit_engine(edit_pipe):
    eng = EditInferenceEngine(edit_pipe, batch_size=2, flush_ms=100.0, **EDIT_KW)
    yield eng
    eng.shutdown()


def _edit_req(i, **kw):
    kw.setdefault("num_inference_steps", 2)
    image = np.random.default_rng(i).integers(0, 256, (24, 20, 3), np.uint8)  # not square
    return EditRequest(instruction=f"edit {i}", image=image, seed=200 + i, **kw)


def test_edit_single_request(edit_pipe):
    with EditInferenceEngine(edit_pipe, batch_size=2, flush_ms=100.0, **EDIT_KW) as eng:
        img = eng.generate(_edit_req(0), timeout=300)
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        s = eng.stats()
        assert s["batches"] == 1 and s["padded_rows"] == 1


def test_edit_deterministic_slot_independent(edit_engine):
    req = _edit_req(1, deterministic=True)
    solo = edit_engine.generate(req, timeout=300)
    futs = [edit_engine.submit(_edit_req(9, deterministic=True)), edit_engine.submit(req)]
    packed = [f.result(timeout=300) for f in futs]
    np.testing.assert_array_equal(solo, packed[1])
    assert not np.array_equal(packed[0], packed[1])


def test_edit_padded_serving_one_program(edit_pipe):
    eng = EditInferenceEngine(edit_pipe, batch_size=2, flush_ms=50.0, padded_max_steps=4,
                              **EDIT_KW)
    try:
        a = eng.generate(_edit_req(20, num_inference_steps=2), timeout=300)
        b = eng.generate(_edit_req(20, num_inference_steps=3), timeout=300)
        padded_keys = [k for k in eng.pipeline.programs if k[0] == "padded"]
        assert len(padded_keys) == 1
        assert not np.array_equal(a, b)
    finally:
        eng.shutdown()


def test_edit_http_roundtrip(edit_engine):
    server, base = _serve(edit=edit_engine)
    try:
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(5).integers(0, 256, (20, 24, 3), np.uint8)).save(
            buf, format="PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        payload = _post(f"{base}/v1/edit", {"instruction": "make it snow", "image_png_b64": b64,
                                            "seed": 11, "num_inference_steps": 2})
        assert _png_of(payload).shape == (16, 16, 3)
        # edit-only server: /v1/generate is 404, a missing image 400
        assert _post_code(f"{base}/v1/generate", {"prompt": "x"})[0] == 404
        assert _post_code(f"{base}/v1/edit", {"instruction": "x"})[0] == 400
        # valid base64 that is not an image, a JPEG: 400, not a dropped socket
        not_png = base64.b64encode(b"not a png").decode()
        assert _post_code(f"{base}/v1/edit", {"instruction": "x", "image_png_b64": not_png})[0] == 400
        jpeg = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpeg, format="JPEG")
        code, body = _post_code(f"{base}/v1/edit", {
            "instruction": "x", "image_png_b64": base64.b64encode(jpeg.getvalue()).decode()})
        assert code == 400 and "not a PNG" in body
        # a string-typed deterministic: 400 (bool("false") would be True)
        assert _post_code(f"{base}/v1/edit", {"instruction": "x", "image_png_b64": b64,
                                              "deterministic": "false"})[0] == 400
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            assert json.load(r)["completed"] >= 1
    finally:
        server.shutdown()


# --------------------------------------------------------------- replicas


def test_replica_group_matches_single_engine(pipeline):
    with InferenceEngine(pipeline, batch_size=BATCH, latent_size=LATENT) as single:
        solo = single.generate(_req(3), timeout=300)
        five = single.generate(_req(5), timeout=300)
    with make_replicas(pipeline, InferenceEngine, 2, devices=["cpu", "cpu"], batch_size=BATCH,
                       latent_size=LATENT, flush_ms=50.0) as group:
        # each replica holds its own copy of every model
        unets = [e.pipeline.unet for e in group.engines]
        assert unets[0] is not unets[1] and pipeline.unet not in unets
        np.testing.assert_array_equal(group.generate(_req(3), timeout=300), solo)
        futs = [group.submit(_req(i)) for i in range(2 * BATCH)]  # needs both replicas
        outs = [f.result(timeout=300) for f in futs]
        s = group.stats()
        assert s["replicas"] == 2 and s["completed"] == 1 + 2 * BATCH
        assert sum(p["batches"] for p in s["per_replica"]) == s["batches"]
        assert all(p["requests"] > 0 for p in s["per_replica"])
        np.testing.assert_array_equal(outs[5], five)  # placement never changes results


def test_make_replicas_caps_at_device_count(pipeline):
    with pytest.raises(ValueError, match="visible devices"):
        make_replicas(pipeline, InferenceEngine, 99, devices=["cpu", "cpu"], batch_size=BATCH,
                      latent_size=LATENT)
    if not torch.cuda.is_available():  # the default is the visible cards: none here
        with pytest.raises(ValueError, match="visible devices"):
            make_replicas(pipeline, InferenceEngine, 1, batch_size=BATCH, latent_size=LATENT)


def test_edit_replicas_pin_transformer_params(edit_pipe):
    kw = dict(batch_size=2, flush_ms=50.0, **EDIT_KW)
    with EditInferenceEngine(edit_pipe, **kw) as single:
        solo = single.generate(_edit_req(2, deterministic=True), timeout=300)
    with make_replicas(edit_pipe, EditInferenceEngine, 2, devices=["cpu", "cpu"], **kw) as group:
        dits = [e.pipeline.transformer for e in group.engines]
        assert dits[0] is not dits[1] and edit_pipe.transformer not in dits
        got = group.generate(_edit_req(2, deterministic=True), timeout=300)
    np.testing.assert_array_equal(solo, got)


def _sd3_pipe():
    from tests.test_torch_sd35 import _pipeline, tiny_cfg

    return _pipeline(tiny_cfg())[0]


# family -> (pipeline, engine class, engine keywords, a request, a program)
_FAMILIES = {
    "sd": lambda: (_sd_pipeline(FactorNet(SD_POLICY, device="cpu")), InferenceEngine,
                   dict(batch_size=2, latent_size=LATENT), _req(1, deterministic=True),
                   lambda p: p.denoise_fn(2, 3.0)),
    "edit": lambda: (_tiny_flux_pipeline(), EditInferenceEngine, dict(batch_size=2, **EDIT_KW),
                     _edit_req(1, deterministic=True),
                     lambda p: p.denoise_fn(4, 4, 4, 2, 2.5)),
    "sd3": lambda: (_sd3_pipe(), SD3InferenceEngine, dict(latent_size=LATENT),
                    SD3InferenceEngine.request(prompt="p", seed=3, num_inference_steps=2,
                                               deterministic=True),
                    lambda p: p.denoise_fn(2, 3.5)),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_pipeline_copies_and_replicas(family):
    """Each family's pipeline, through the base's one copy method: ``replace``
    swaps only what it is given, starts an empty program cache and leaves
    the original untouched; ``make_replicas`` copies exactly ``MODULES``
    (every other attribute shared) and serves what one engine serves."""
    pipe, engine_cls, kw, req, program = _FAMILIES[family]()
    assert isinstance(pipe, Pipeline) and set(pipe.MODULES) <= set(vars(pipe))
    program(pipe)
    cache = dict(pipe.programs)
    assert cache and all(callable(fn) for fn in cache.values())
    state = {name: getattr(pipe, name) for name in vars(pipe)}

    net = copy.deepcopy(pipe.factor_net)
    swapped = pipe.replace(factor_net=net)
    assert swapped.factor_net is net and not swapped.programs
    assert all(getattr(swapped, n) is v for n, v in state.items() if n not in ("factor_net",
                                                                              "_programs"))
    with pytest.raises(AttributeError, match="no attribute"):
        pipe.replace(not_a_model=None)

    with engine_cls(pipe.replace(), flush_ms=1.0, **kw) as single:
        solo = single.generate(req, timeout=300)
    with make_replicas(pipe, engine_cls, 2, devices=["cpu", "cpu"], flush_ms=1.0,
                       **kw) as group:
        for eng in group.engines:
            rep_pipe = eng.pipeline
            assert type(rep_pipe) is type(pipe) and not rep_pipe.programs
            for name, value in state.items():
                if name in pipe.MODULES:
                    assert value is not getattr(rep_pipe, name), name
                    assert all(torch.equal(a, b) for a, b in zip(
                        value.state_dict().values(), getattr(rep_pipe, name).state_dict().values()))
                elif name == "device":
                    assert rep_pipe.device == torch.device("cpu")
                elif name != "_programs":
                    assert getattr(rep_pipe, name) is value, name
        a, b = (e.pipeline.factor_net for e in group.engines)
        assert a is not b
        np.testing.assert_array_equal(group.generate(req, timeout=300), solo)
    # the original pipeline is untouched
    assert {name: getattr(pipe, name) for name in vars(pipe)} == state
    assert dict(pipe.programs) == cache


class _StubPipeline(Pipeline):
    """A model family the serving layer has never seen: a 1x1-conv
    "denoiser" over 3 latent channels, prompt ids that are the prompts'
    lengths, and programs from the base's cache.  Images are the sigmoid
    of the final latents at the latents' size."""

    MODULES = ("denoiser",)
    LEARNABLE_SOLVER = "fmppo"

    def __init__(self):
        super().__init__("cpu")
        self.denoiser = torch.nn.Conv2d(3, 3, 1)
        self.calls = []

    @property
    def latent_channels(self) -> int:
        return 3

    def tokenize(self, prompts, max_length=None):
        return np.array([[len(p)] for p in prompts], np.int64)

    def _run(self, x, ids, scale):
        y = self.denoiser(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y * scale + torch.as_tensor(ids, dtype=torch.float32).view(-1, 1, 1, 1) * 0.01

    def __call__(self, generator, ids, noise, num_inference_steps, guidance_scale, solver,
                 deterministic_policy, padded_max_steps, record):
        self.calls.append((num_inference_steps, solver, deterministic_policy, padded_max_steps))
        with torch.inference_mode():
            program = self._program(
                (num_inference_steps, guidance_scale), solver, record, deterministic_policy,
                lambda det: lambda g, x, i: (self._run(x, i, 0.5), "trajectory"),
                lambda: lambda g, x, i: self._run(x, i, 0.25))
            latents, _ = program(generator, noise, ids)
        return torch.sigmoid(latents), None


def _stub_image(pipe, prompt, seed, scale):
    """The engine's image of a lone request: row 0 of its batch of 2."""
    noise = tengine.seed_noise([seed, seed], (LATENT, LATENT, 3))
    with torch.no_grad():
        latents = pipe._run(noise, [[len(prompt)]] * 2, scale)
    return tengine._uint8_in_program(torch.sigmoid(latents))[0]


def test_a_new_family_serves_through_the_pipeline_seam():
    """A pipeline that derives from the base, unknown to ``serve/``, is
    served by ``InferenceEngine`` (tokenize, latent channels, its learnable
    solver's pad-to-max routing, the deterministic knob, replicas, the
    refusal of a mesh for a family without a tensor-parallel rule)."""
    pipe = _StubPipeline()
    with InferenceEngine(pipe, batch_size=2, latent_size=LATENT, flush_ms=1.0,
                         padded_max_steps=4) as eng:
        learned = eng.generate(GenerationRequest(prompt="abc", seed=5, solver="fmppo",
                                                 num_inference_steps=3), timeout=300)
        base = eng.generate(GenerationRequest(prompt="abcdef", seed=6, solver="euler",
                                              num_inference_steps=3, deterministic=True),
                            timeout=300)
    np.testing.assert_array_equal(learned, _stub_image(pipe, "abc", 5, 0.5).numpy())
    np.testing.assert_array_equal(base, _stub_image(pipe, "abcdef", 6, 0.25).numpy())
    # the learnable solver routes through the pad-to-max program; a baseline
    # keeps its per-count one, and its deterministic knob forks nothing
    assert pipe.calls == [(3, "fmppo", False, 4), (3, "euler", False, None)]
    assert set(pipe.programs) == {(3, 3.0, "fmppo", False, False), (3, 3.0, "euler", False, False)}
    with make_replicas(pipe, InferenceEngine, 2, devices=["cpu", "cpu"], batch_size=2,
                       latent_size=LATENT, flush_ms=1.0) as group:
        assert [e.pipeline.denoiser is pipe.denoiser for e in group.engines] == [False, False]
        np.testing.assert_array_equal(group.generate(GenerationRequest(
            prompt="abc", seed=5, solver="fmppo", num_inference_steps=3), timeout=300), learned)
    mesh = Mesh(rank=0, world=2, dp=2, tp=1, data_rank=0, model_rank=0, data_group=None,
                model_group=None, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="one card"):
        InferenceEngine(pipe, batch_size=2, latent_size=LATENT, mesh=mesh)


# -------------------------------------------------------------- hardening


class _SlowEngine(InferenceEngine):
    """_dispatch sleeps so that a batch can be caught in flight."""

    def _dispatch(self, requests):
        time.sleep(0.8)
        return [np.zeros(SHAPE, np.uint8) for _ in requests]


def test_dispatch_overlaps_fetch(pipeline):
    """The worker dispatches batch N+1 while batch N is still being fetched:
    batch A's fetch blocks until batch B's dispatch has been observed."""
    dispatched = []
    second_dispatch, release_fetch = threading.Event(), threading.Event()

    class _OverlapEngine(InferenceEngine):
        def _dispatch(self, requests):
            dispatched.append(requests[0].seed)
            if len(dispatched) >= 2:
                second_dispatch.set()
            return [np.zeros(SHAPE, np.uint8) for _ in requests]

        def _fetch(self, images, n):
            release_fetch.wait(timeout=30)
            return images[:n]

    eng = _OverlapEngine(pipeline, batch_size=1, latent_size=LATENT, flush_ms=1.0)
    try:
        fut_a, fut_b = eng.submit(_req(0)), eng.submit(_req(1))
        assert second_dispatch.wait(timeout=10), "batch B never dispatched during A's fetch"
        release_fetch.set()
        assert fut_a.result(timeout=30).shape == SHAPE
        assert fut_b.result(timeout=30).shape == SHAPE
        assert eng.stats()["batches"] == 2
    finally:
        release_fetch.set()
        eng.shutdown(timeout=10)


def test_shutdown_with_inflight_batch_completes_it(pipeline):
    eng = _SlowEngine(pipeline, batch_size=1, latent_size=LATENT, flush_ms=1.0)
    try:
        fut_a = eng.submit(_req(0))
        time.sleep(0.2)  # the worker picks A up
        fut_b = eng.submit(_req(1))  # queued behind A
        eng.shutdown(timeout=0.05)  # the join expires while A is in flight
        assert fut_a.result(timeout=10).shape == SHAPE
        with pytest.raises(EngineShutDown):
            fut_b.result(timeout=10)
        with pytest.raises(EngineShutDown):
            eng.submit(_req(2))
    finally:
        eng.shutdown(timeout=10)


def test_request_deadline_expires_queued_requests(pipeline):
    eng = InferenceEngine(pipeline, batch_size=2, latent_size=LATENT, flush_ms=1.0,
                          max_wait_s=0.0)
    try:
        with pytest.raises(RequestExpired):
            eng.generate(_req(0), timeout=30)
        assert eng.stats()["expired"] == 1 and eng.stats()["batches"] == 0
    finally:
        eng.shutdown()


def test_no_deadline_by_default(engine):
    assert engine.generate(_req(0), timeout=300).shape == SHAPE
    assert engine.stats()["expired"] == 0


def test_oversized_edit_image_rejected_pre_decode():
    side = int(np.sqrt(MAX_EDIT_PIXELS)) + 8
    buf = io.BytesIO()
    Image.new("L", (side, side)).save(buf, format="PNG")
    with pytest.raises(ValueError, match="exceeds"):
        _decode_image_b64(base64.b64encode(buf.getvalue()).decode())
    buf2 = io.BytesIO()
    Image.new("RGB", (20, 24)).save(buf2, format="PNG")
    assert _decode_image_b64(base64.b64encode(buf2.getvalue()).decode()).shape == (24, 20, 3)


def test_oversized_body_rejected_413(edit_engine):
    server, _ = _serve(edit=edit_engine)
    host, port = server.server_address[:2]
    try:
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.putrequest("POST", "/v1/edit")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()  # no body: the server must not wait for it
        resp = conn.getresponse()
        assert resp.status == 413 and b"exceeds" in resp.read()
        conn.close()
    finally:
        server.shutdown()


def test_expired_request_maps_to_503(pipeline):
    eng = InferenceEngine(pipeline, batch_size=2, latent_size=LATENT, flush_ms=1.0,
                          max_wait_s=0.0)
    server, base = _serve(eng)
    try:
        code, body = _post_code(f"{base}/v1/generate", {"prompt": "x", "num_inference_steps": 2})
        assert code == 503 and "RequestExpired" in body
    finally:
        server.shutdown()
        eng.shutdown()


def test_http_roundtrip(pipeline):
    eng = InferenceEngine(pipeline, batch_size=2, latent_size=LATENT, flush_ms=10.0)
    server, base = _serve(eng)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}
        payload = _post(f"{base}/v1/generate", {"prompt": "a corgi", "seed": 7,
                                                "num_inference_steps": 2})
        img = _png_of(payload)
        assert img.shape == SHAPE and payload["seed"] == 7 and payload["latency_ms"] > 0
        direct = eng.generate(GenerationRequest(prompt="a corgi", seed=7, num_inference_steps=2),
                              timeout=300)
        np.testing.assert_array_equal(img, direct)  # the HTTP path equals a direct call
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["completed"] >= 2 and stats["batch_size"] == 2
        assert _post_code(f"{base}/v1/generate", {})[0] == 400  # missing prompt
        assert _post_code(f"{base}/v1/edit", {"instruction": "x"})[0] == 404  # no edit engine
        assert _post_code(f"{base}/v1/nothing", {"prompt": "x"})[0] == 404
        # an engine error is a 500 with its message; the server goes on
        code, body = _post_code(f"{base}/v1/generate", {"prompt": "x", "solver": "amed",
                                                        "num_inference_steps": 5})
        assert code == 500 and "AMED" in body
        assert _post(f"{base}/v1/generate", {"prompt": "x", "num_inference_steps": 2})
    finally:
        server.shutdown()
        eng.shutdown()


def test_http_serves_both_families(pipeline, edit_engine):
    eng = InferenceEngine(pipeline, batch_size=2, latent_size=LATENT, flush_ms=10.0)
    server, base = _serve(eng, edit_engine)
    try:
        assert _png_of(_post(f"{base}/v1/generate", {"prompt": "x", "num_inference_steps": 2}
                             )).shape == SHAPE
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            assert set(json.load(r)) == {"generate", "edit"}
        with pytest.raises(ValueError, match="at least one engine"):
            make_server(port=0)
    finally:
        server.shutdown()
        eng.shutdown()


# ------------------------------------------------------------- /v1/refine


class _CapturePipe(TextToImagePipeline):
    """A text-to-image pipeline whose call records each batch's (steps,
    solver) and returns an image that is an injective function of the
    initial noise (equal PNGs <=> equal noise)."""

    tokenizer = None
    device = torch.device("cpu")

    def __init__(self, base, captured):
        self.text_encoder, self.unet, self.captured = base.text_encoder, base.unet, captured

    def __call__(self, generator, ids, noise, num_inference_steps, guidance_scale, solver,
                 deterministic_policy, padded_max_steps, record):
        self.captured.append((num_inference_steps, solver))
        return (noise[..., :3].repeat(1, 2, 2, 1) * 0.05 + 0.5).clamp(0, 1), None


def test_refine_applies_teacher_defaults_and_shares_noise(pipeline):
    captured = []
    eng = InferenceEngine(_CapturePipe(pipeline, captured), batch_size=2, latent_size=LATENT,
                          flush_ms=1.0)
    server, base = _serve(eng)
    try:
        body_p = _post(f"{base}/v1/generate", {"prompt": "a corgi", "seed": 7,
                                               "num_inference_steps": 2})
        body_r = _post(f"{base}/v1/refine", {"prompt": "a corgi", "seed": 7})
        assert body_p["seed"] == body_r["seed"] == 7
        assert captured == [(2, "consistencysolver"), (40, "multistep-dpm")]
        # same seed -> the same initial noise: the refine starts from the preview's
        assert body_p["image_png_b64"] == body_r["image_png_b64"]
        _post(f"{base}/v1/refine", {"prompt": "a corgi", "seed": 7, "num_inference_steps": 12})
        assert captured[-1] == (12, "multistep-dpm")  # client fields beat the defaults
    finally:
        server.shutdown()
        eng.shutdown()


def test_refine_prewarm_signature():
    req = GenerationRequest(prompt="prewarm", **InferenceEngine.REFINE_DEFAULTS)
    assert req.num_inference_steps == 40 and req.solver == "multistep-dpm"
    assert req.program_key != GenerationRequest(prompt="prewarm").program_key


class _EditCapturePipe(FluxKontextPipeline):
    device = torch.device("cpu")

    def __init__(self, base, captured):
        self.vae, self.t5, self.clip, self.captured = base.vae, base.t5, base.clip, captured

    def __call__(self, generator, t5_ids, clip_ids, ref, noise, num_inference_steps,
                 guidance_scale, solver, deterministic_policy, record, padded_max_steps):
        self.captured.append((num_inference_steps, solver, float(guidance_scale)))
        return (noise[..., :3].repeat(1, 2, 2, 1) * 0.05 + 0.5).clamp(0, 1), None


def test_edit_refine_applies_teacher_defaults_and_shares_noise(edit_pipe):
    captured = []
    eng = EditInferenceEngine(_EditCapturePipe(edit_pipe, captured), batch_size=1,
                              flush_ms=1.0, **EDIT_KW)
    server, base = _serve(edit=eng)
    try:
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(5).integers(0, 256, (20, 24, 3), np.uint8)).save(
            buf, format="PNG")
        img_b64 = base64.b64encode(buf.getvalue()).decode()
        body_p = _post(f"{base}/v1/edit", {"instruction": "make it snow", "image_png_b64": img_b64,
                                           "seed": 7, "num_inference_steps": 2})
        body_r = _post(f"{base}/v1/edit/refine", {"instruction": "make it snow",
                                                  "image_png_b64": img_b64, "seed": 7})
        assert captured == [(2, "fmppo", 2.5), (28, "euler", 2.5)]
        assert body_p["image_png_b64"] == body_r["image_png_b64"]
        _post(f"{base}/v1/edit/refine", {"instruction": "make it snow", "image_png_b64": img_b64,
                                         "seed": 7, "num_inference_steps": 12,
                                         "guidance_scale": 4.0})
        assert captured[-1] == (12, "euler", 4.0)
    finally:
        server.shutdown()
        eng.shutdown()


def test_edit_refine_prewarm_signature():
    gray = np.full((16, 16, 3), 127, np.uint8)
    req = EditRequest(instruction="prewarm", image=gray, **EditInferenceEngine.REFINE_DEFAULTS)
    assert (req.num_inference_steps, req.solver, req.guidance_scale) == (28, "euler", 2.5)
    assert req.program_key != EditRequest(instruction="prewarm", image=gray).program_key


# ---------------------------------------------------- multi-size batching


def _spy_shapes(eng):
    dispatched = []
    orig = eng._dispatch

    def spy(requests):
        out = orig(requests)
        dispatched.append(int(out.shape[0]))
        return out

    eng._dispatch = spy
    return dispatched


def test_batch_sizes_pick_smallest_shape(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, batch_sizes=(2, BATCH), latent_size=LATENT,
                          flush_ms=150.0)
    try:
        assert eng.batch_sizes == (2, BATCH) and eng.batch_size == BATCH
        img = eng.generate(_req(0), timeout=300)
        s = eng.stats()
        assert s["batches"] == 1 and s["padded_rows"] == 1
        assert s["pad_waste_pct"] == pytest.approx(50.0)
        futs = [eng.submit(_req(i)) for i in range(3)]  # overflow the small shape
        imgs = [f.result(timeout=300) for f in futs]
        s = eng.stats()
        assert s["batches"] == 2 and s["padded_rows"] == 1 + (BATCH - 3)
        assert all(im.shape == SHAPE for im in imgs)
    finally:
        eng.shutdown()
    with InferenceEngine(pipeline, batch_size=BATCH, latent_size=LATENT, flush_ms=150.0) as full:
        # on the CPU the numerics do not depend on the batch shape
        np.testing.assert_array_equal(img, full.generate(_req(0), timeout=300))


def test_batch_sizes_deterministic_pins_max_shape(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, batch_sizes=(2, BATCH), latent_size=LATENT,
                          flush_ms=150.0)
    dispatched = _spy_shapes(eng)  # the shape the program really ran at
    try:
        img = eng.generate(_req(0, deterministic=True), timeout=300)
        s = eng.stats()
        assert s["batches"] == 1 and s["padded_rows"] == BATCH - 1
        assert dispatched == [BATCH] and img.shape == SHAPE
        futs = [eng.submit(_req(0, deterministic=True)), eng.submit(_req(1, deterministic=True))]
        imgs = [f.result(timeout=300) for f in futs]
        assert eng.stats()["padded_rows"] == (BATCH - 1) + (BATCH - 2)
        assert set(dispatched) == {BATCH}
        np.testing.assert_array_equal(img, imgs[0])
        assert eng.prewarm(_req(7, deterministic=True), timeout=300) == 1  # the max shape only
    finally:
        eng.shutdown()


def test_adaptive_boundary_stop_dispatches_at_shape_boundary(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, batch_sizes=(2, BATCH), latent_size=LATENT,
                          flush_ms=30_000.0, adaptive_flush=True)
    dispatched = _spy_shapes(eng)
    try:
        with eng._lock:  # an arrival gap so large the next shape cannot fill in time
            eng._ema_gap_s = 30.0
            eng._last_submit = time.monotonic()
        t0 = time.monotonic()
        futs = [eng.submit(_req(0)), eng.submit(_req(1))]
        imgs = [f.result(timeout=300) for f in futs]
        elapsed = time.monotonic() - t0
        assert dispatched == [2]
        s = eng.stats()
        assert s["padded_rows"] == 0 and s["batches"] == 1
        assert elapsed < 25.0, f"boundary stop did not fire ({elapsed:.1f}s)"
        assert all(img.shape == SHAPE for img in imgs)
        assert eng._boundary_stop(2, remain_s=5.0)
        assert not eng._boundary_stop(1, remain_s=5.0)
        assert not eng._boundary_stop(BATCH, remain_s=5.0)
        with eng._lock:
            eng._ema_gap_s = None
        assert not eng._boundary_stop(2, remain_s=5.0)
    finally:
        eng.shutdown()


def test_adaptive_split_flush_dispatches_exact_shapes(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, batch_sizes=(2, BATCH), latent_size=LATENT,
                          flush_ms=300.0, adaptive_flush=True)
    dispatched = _spy_shapes(eng)
    try:
        futs = [eng.submit(_req(i)) for i in range(3)]
        imgs = [f.result(timeout=300) for f in futs]
        assert dispatched == [2, 2], dispatched  # never a padded batch of 4
        s = eng.stats()
        assert s["batches"] == 2 and s["padded_rows"] == 1
        assert all(img.shape == SHAPE for img in imgs)
        assert eng._expiry_trim(3) == 2 and eng._expiry_trim(1) == 1
        assert eng._expiry_trim(2) == 2 and eng._expiry_trim(BATCH) == BATCH
    finally:
        eng.shutdown()


def test_batch_sizes_prewarm_warms_every_shape(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, batch_sizes=(2, BATCH), latent_size=LATENT,
                          flush_ms=150.0)
    try:
        assert eng.prewarm(_req(0), _req(1), timeout=300) == 2  # one key x two shapes
        assert len(eng._programs) == 1
        before = eng.stats()["batches"]
        assert eng.generate(_req(5), timeout=300).shape == SHAPE
        assert eng.stats()["batches"] == before + 1 and len(eng._programs) == 1
    finally:
        eng.shutdown()


def test_adaptive_flush_window_scales_with_arrivals(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, latent_size=LATENT, flush_ms=200.0,
                          adaptive_flush=True)
    try:
        assert eng._flush_window() == pytest.approx(0.2)  # no estimate yet: the cap
        eng._ema_gap_s = 0.010
        assert eng._flush_window() == pytest.approx(0.04)  # 4 slots x 10 ms
        eng._ema_gap_s = 1.0
        assert eng._flush_window() == pytest.approx(0.2)
        assert eng.generate(_req(0), timeout=300).shape == SHAPE
    finally:
        eng.shutdown()


def _blocked_dispatch_spy(eng):
    """The FIRST dispatch parks until ``release`` (holding the worker while
    the test loads the queue); every dispatched prompt list is recorded."""
    order = []
    entered, release = threading.Event(), threading.Event()
    orig = eng._dispatch

    def spy(requests):
        entered.set()
        assert release.wait(30), "the test never released the worker"
        order.append([r.prompt for r in requests])
        return orig(requests)

    eng._dispatch = spy
    return order, entered, release


def test_split_flush_remainder_does_not_starve_other_signature(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, batch_sizes=(2, BATCH), latent_size=LATENT,
                          flush_ms=200.0, adaptive_flush=True)
    order, entered, release = _blocked_dispatch_spy(eng)
    try:
        primer = eng.submit(_req(99))
        assert entered.wait(30)
        # arrival order A0, A1, B, A2 (B another program signature)
        futs = [eng.submit(_req(0)), eng.submit(_req(1)),
                eng.submit(_req(3, num_inference_steps=3)), eng.submit(_req(2))]
        release.set()
        primer.result(timeout=300)
        for f in futs:
            f.result(timeout=300)
        assert order == [["prompt 99"], ["prompt 0", "prompt 1"], ["prompt 3"], ["prompt 2"]], order
    finally:
        release.set()
        eng.shutdown()


def test_post_idle_burst_fills_the_batch(pipeline):
    eng = InferenceEngine(pipeline, batch_size=BATCH, batch_sizes=(2, BATCH), latent_size=LATENT,
                          flush_ms=200.0, adaptive_flush=True)
    order, entered, release = _blocked_dispatch_spy(eng)
    try:
        primer = eng.submit(_req(99))
        assert entered.wait(30)
        with eng._lock:  # idle for an hour: a stale EMA
            eng._ema_gap_s = 50.0
            eng._last_submit = time.monotonic() - 3600.0
        futs = [eng.submit(_req(i)) for i in range(BATCH)]
        with eng._lock:  # the idle gap entered the EMA clamped at the window
            assert eng._ema_gap_s < 50.0
        release.set()
        primer.result(timeout=300)
        for f in futs:
            f.result(timeout=300)
        assert [len(b) for b in order] == [1, BATCH], order
    finally:
        release.set()
        eng.shutdown()


def test_prewarm_timeout_bounds_a_hung_program(pipeline):
    """The budget is per program: a hung dispatch raises TimeoutError."""
    eng = InferenceEngine(pipeline, batch_size=BATCH, latent_size=LATENT, flush_ms=150.0)
    release = threading.Event()

    def hang(requests):
        release.wait(30)
        raise RuntimeError("abandoned prewarm dispatch")

    eng._dispatch = hang
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            eng.prewarm(_req(0), timeout=0.3)
        assert time.monotonic() - t0 < 10.0
    finally:
        release.set()
        eng.shutdown()


def test_prewarm_budget_is_per_program(pipeline):
    """Three programs that each take 0.4 s pass a 1 s per-program budget
    that a total budget would break."""
    eng = InferenceEngine(pipeline, batch_size=1, latent_size=LATENT, flush_ms=10.0)
    orig = eng._dispatch

    def slow(requests):
        time.sleep(0.4)
        return orig(requests)

    eng._dispatch = slow
    try:
        assert eng.prewarm(_req(0), _req(1, num_inference_steps=3),
                           _req(2, num_inference_steps=1), timeout=1.0) == 3
    finally:
        eng.shutdown()


# -------------------------------------------------------- policy hot reload


def _fresh_policy_engine(policy_pipeline, **kw):
    return InferenceEngine(copy.copy(policy_pipeline), batch_size=2, latent_size=LATENT,
                           flush_ms=1.0, **kw)


def _biased_state(net, hot=7):
    """A state whose mode actions differ from the zero-initialised head's
    (argmax index 0 per dim): a head bias on grid index ``hot``."""
    state = {k: v.clone() for k, v in net.state_dict().items()}
    cfg = net.config
    bias = torch.zeros((cfg.action_dims, cfg.num_actions))
    bias[:, hot] = 5.0
    state["head.bias"] = bias.reshape(-1)
    return state


def _export(dirpath, state, cfg):
    net = FactorNet(cfg, device="cpu")
    net.load_state_dict(state)
    return policy_io.save_factor_net(net, str(dirpath))


def test_hot_reload_swaps_policy_without_retrace(policy_pipeline, tmp_path):
    fnet = policy_pipeline.factor_net
    new_state = _biased_state(fnet)
    ckpt = str(tmp_path / "export")
    _export(ckpt, new_state, fnet.config)

    eng = _fresh_policy_engine(policy_pipeline)
    try:
        req = _req(0, deterministic=True)
        golden_old = eng.generate(req, timeout=300)

        # gate the fetch so that a batch is provably in flight when the swap lands
        fetch_started, swap_done = threading.Event(), threading.Event()

        def gated_fetch(images, n):
            fetch_started.set()
            assert swap_done.wait(60)
            return InferenceEngine._fetch(images, n)

        eng._fetch = gated_fetch
        fut = eng.submit(req)
        assert fetch_started.wait(120)
        out = eng.load_factor_ckpt(ckpt)
        swap_done.set()
        inflight = fut.result(timeout=300)
        del eng._fetch  # back to the class's static method
        np.testing.assert_array_equal(inflight, golden_old)  # finished on the OLD policy
        assert out["factor_net_config"]["order_dim"] == fnet.config.order_dim

        after = eng.generate(req, timeout=300)
        assert not np.array_equal(after, golden_old)
        # ... equal to a fresh engine built on the new net
        net2 = copy.deepcopy(fnet)
        net2.load_state_dict(new_state)
        pipe2 = policy_pipeline.replace(factor_net=net2)
        with InferenceEngine(pipe2, batch_size=2, latent_size=LATENT, flush_ms=1.0) as eng2:
            np.testing.assert_array_equal(after, eng2.generate(req, timeout=300))
        assert len(eng._programs) == 1  # one serving program across the reload
    finally:
        eng.shutdown()


def test_hot_reload_does_not_reuse_the_old_denoise_cache(policy_pipeline):
    """The cached denoise functions hold the net they were built with: the
    swap must bring a new net AND an empty cache, and never write into the
    resident net (a batch in flight reads it)."""
    eng = _fresh_policy_engine(policy_pipeline)
    try:
        req = _req(1, deterministic=True)
        before = eng.generate(req, timeout=300)
        old_pipe, old_net = eng.pipeline, eng.pipeline.factor_net
        old_state = {k: v.clone() for k, v in old_net.state_dict().items()}
        old_cache = dict(old_pipe.programs)
        assert old_cache
        eng.update_factor_params(_biased_state(old_net, hot=3))
        new_pipe = eng.pipeline
        assert new_pipe is not old_pipe and new_pipe.factor_net is not old_net
        assert not new_pipe.programs
        assert all(torch.equal(old_state[k], v) for k, v in old_net.state_dict().items())
        assert not np.array_equal(eng.generate(req, timeout=300), before)
        assert not set(new_pipe.programs.values()) & set(old_cache.values())
        assert dict(old_pipe.programs) == old_cache  # the old pipeline's cache is untouched
        assert policy_pipeline.factor_net is old_net  # the caller's pipeline is untouched
    finally:
        eng.shutdown()


def test_hot_reload_rejects_mismatched_dims(policy_pipeline, tmp_path):
    fnet = policy_pipeline.factor_net
    other_cfg = dataclasses.replace(fnet.config, num_actions=21)
    other = FactorNet(other_cfg, device="cpu")
    ckpt = policy_io.save_factor_net(other, str(tmp_path / "other"))
    eng = _fresh_policy_engine(policy_pipeline)
    try:
        with pytest.raises(ValueError, match="restart"):
            eng.load_factor_ckpt(ckpt)
        with pytest.raises(ValueError, match="shape mismatch|tree mismatch"):
            eng.update_factor_params(other.state_dict())
        with pytest.raises(ValueError, match="tree mismatch"):
            eng.update_factor_params({"x": torch.zeros(3)})
    finally:
        eng.shutdown()


def test_hot_reload_requires_a_policy(pipeline):
    eng = InferenceEngine(pipeline, batch_size=2, latent_size=LATENT, flush_ms=1.0)
    try:
        with pytest.raises(ValueError, match="factor_net is None"):
            eng.update_factor_params({"x": torch.zeros(3)})
    finally:
        eng.shutdown()


def test_admin_reload_endpoint(policy_pipeline, tmp_path):
    fnet = policy_pipeline.factor_net
    good = _export(tmp_path / "good", _biased_state(fnet), fnet.config)
    bad_cfg = dataclasses.replace(fnet.config, num_actions=21)
    bad = policy_io.save_factor_net(FactorNet(bad_cfg, device="cpu"), str(tmp_path / "bad"))
    eng = _fresh_policy_engine(policy_pipeline)
    server, base = _serve(eng)
    url = f"{base}/v1/admin/reload_factor"
    try:
        probe = _req(0, deterministic=True)
        before = eng.generate(probe, timeout=300)
        out = _post(url, {"path": good})
        assert out["ok"] and out["engine"] == "generate"
        assert not np.array_equal(eng.generate(probe, timeout=300), before)
        assert _post_code(url, {"path": bad})[0] == 409
        assert _post_code(url, {})[0] == 400
        assert _post_code(url, {"path": good, "engine": "edit"})[0] == 400
        assert _post_code(url, {"path": str(tmp_path / "nothing")})[0] == 400
    finally:
        server.shutdown()
        eng.shutdown()


def test_replica_group_hot_reload_reaches_every_replica(policy_pipeline, tmp_path):
    fnet = policy_pipeline.factor_net
    good = _export(tmp_path / "good", _biased_state(fnet), fnet.config)
    with make_replicas(policy_pipeline, InferenceEngine, 2, devices=["cpu", "cpu"], batch_size=2,
                       latent_size=LATENT, flush_ms=1.0) as group:
        out = group.load_factor_ckpt(good)
        assert out["replicas"] == 2
        for eng in group.engines:
            assert torch.equal(eng.pipeline.factor_net.head.bias, _biased_state(fnet)["head.bias"])
