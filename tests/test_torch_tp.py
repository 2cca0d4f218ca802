"""Tensor parallelism of the port (``consolver_torch/dist/tp.py``), and the
mesh paths of its edit trainer and serving engines, over gloo processes on
the CPU, against the JAX package (``consolver_tpu/dist/tp.py`` on its
virtual CPU mesh) and the port's unsharded runs.

Two ranks run the TP-2 forwards, the data-parallel and TP engines and the
data-parallel edit trainer (``tests/torch_dist_workers.py::tp_suite_rank``);
four ranks a 2 x 2 mesh (the edit trainer with the DiT split, TP edit
serving).  The rule checks that need no collective run here, on a mesh
without process groups.  Tolerances, f32:

* a TP-2 forward against the unsharded port model 1e-5 (the row-parallel
  layers sum two partial products; int8 row splits sum exact int32); against
  the JAX package's ``shard_params_by_rules`` forward the port's model
  tolerances (the tiny DiT 2e-4, ``tests/test_torch_flux.py``; the tiny UNet
  1e-4, ``tests/test_torch_models.py``);
* a data-parallel engine against the unsharded engine: bit-equal (each
  rank runs its rows of the deterministic program, whose outputs do not
  depend on the batch slot); a TP edit within one uint8 step (the all_reduce
  reorders partial sums, as the JAX test);
* the data-parallel edit trainer against the one-process trainer at
  ``num_groups = dp``: rewards 1e-4; the 2 x 2 run against the 2 x 1 one
  within ``tests/test_torch_train_edit.py``'s reward limit (2e-3 dB).
"""

import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from consolver_torch.dist import launch
from consolver_torch.dist import tp
from consolver_torch.dist.mesh import Mesh
from consolver_torch.kernels.quant import Int4Linear, Int8Linear, quantize_like
from consolver_torch.models import flux as tflux
from consolver_torch.models.convert import _canonical
from consolver_torch.rewards import metrics as tmetrics
from consolver_torch.rl import train as ttrain
from consolver_torch.rl.train_edit import EditPPOTrainer
from consolver_torch.serve.engine import EditInferenceEngine, InferenceEngine
from consolver_tpu.dist import mesh as jmesh
from consolver_tpu.dist import tp as jtp
from consolver_tpu.models import flux as jflux
from tests import torch_dist_workers as workers
from tests.test_torch_flux import DIT_TOL, _perturb, _tiny_dit_inputs
from tests.test_torch_models import MODEL_TOL, _tiny_unet
from tests.test_torch_train_edit import _batch as _edit_batch
from tests.test_torch_train_edit import _configs as _edit_configs
from tests.test_torch_train_edit import _pipelines as _edit_pipelines
from tests.test_torch_train_edit import base  # noqa: F401  (fixture)

SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)
EDIT_TRAIN_FIELDS = dict(guidance_scale=2.5, min_inference_steps=2, max_inference_steps=4, seed=0)
EDIT_ROWS = {"dp": [3, 4], "tp": [7], "grid": [7, 8]}
EDIT_BATCH = {"dp": 2, "tp": 1, "grid": 2}


def _fake_mesh(tp_size, model_rank=0):
    """A mesh without process groups: enough to split layers (no collective)."""
    return Mesh(rank=model_rank, world=tp_size, dp=1, tp=tp_size, data_rank=0,
                model_rank=model_rank, data_group=None, model_group=None,
                device=torch.device("cpu"), backend="gloo")


@pytest.fixture(scope="module")
def tiny_flux():
    """The JAX tiny DiT (perturbed init) and the port's copy of it."""
    cfg = jflux.FluxConfig.tiny()
    model = jflux.FluxTransformer(cfg)
    args = _tiny_dit_inputs()
    params = _perturb(jax.jit(model.init)(jax.random.key(0), *map(jnp.asarray, args)), 4)
    from consolver_torch.models.convert import load_jax_params

    tmodel = load_jax_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(), device="cpu"), params)
    return model, params, tmodel, args


@pytest.fixture(scope="module")
def tiny_unet():
    jmod, params, tmod = _tiny_unet()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    return jmod, params, tmod, (x, np.array([999, 500]), ctx)


def _jax_tp_forward(model, params, args, rules, tp_size=2):
    mesh = jmesh.make_mesh(num_devices=tp_size, axis_shape=(1, tp_size),
                           axis_names=(jmesh.DATA_AXIS, jmesh.MODEL_AXIS))
    sharded = jtp.shard_params_by_rules(mesh, params, rules)
    args = [jax.device_put(jnp.asarray(a), jmesh.replicated(mesh)) for a in args]
    return np.asarray(jax.jit(model.apply)(sharded, *args))


@pytest.fixture(scope="module")
def two_ranks(tiny_flux, tiny_unet, base, tmp_path_factory):  # noqa: F811
    _, _, tmodel, flux_args = tiny_flux
    _, _, tunet, unet_args = tiny_unet
    _, tpipe = _edit_pipelines(base)
    payload = pickle.dumps({
        "flux": pickle.dumps((tmodel, [torch.from_numpy(a) for a in flux_args])),
        "unet": pickle.dumps((tunet, [torch.from_numpy(a) for a in unet_args])),
        "edit_pipe": pickle.dumps(tpipe), "edit_train_fields": EDIT_TRAIN_FIELDS,
        "edit_batch_rows": _edit_batch(rows=4), "edit_rows": EDIT_ROWS, "edit_batch": EDIT_BATCH,
        "tmp": str(tmp_path_factory.mktemp("tp2")),
    })
    return launch.spawn(workers.tp_suite_rank, 2, timeout_s=120, args=(payload,))


@pytest.fixture(scope="module")
def grid_ranks(base, tmp_path_factory):  # noqa: F811
    _, tpipe = _edit_pipelines(base)
    payload = pickle.dumps({
        "grid": True, "edit_pipe": pickle.dumps(tpipe), "edit_train_fields": EDIT_TRAIN_FIELDS,
        "edit_batch_rows": _edit_batch(rows=4), "edit_rows": EDIT_ROWS, "edit_batch": EDIT_BATCH,
        "tmp": str(tmp_path_factory.mktemp("tp22")),
    })
    return launch.spawn(workers.tp_suite_rank, 4, timeout_s=120, args=(payload,))


# ------------------------------------------------------------------ rules
def _jax_sharded_layers(params, rules, tp_size):
    """Module paths (canonical, '/'-joined) whose kernel JAX splits."""
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(p.key if hasattr(p, "key") else str(p) for p in path)
        if not name.endswith("/kernel"):
            continue
        spec = jtp._spec_for_leaf(name, leaf, rules)
        split = [dim for dim, axis in enumerate(spec) if axis is not None]
        if split and all(np.shape(leaf)[d] % tp_size == 0 for d in split):
            out.add(name[len("params/"):-len("/kernel")])
    return out


def _port_sharded_layers(report):
    return {_canonical(p).replace(".", "/") for kind in (tp.COLUMN, tp.ROW, tp.GATHERED)
            for p in report[kind]}


@pytest.mark.parametrize("model", ["flux", "unet"])
def test_rules_shard_the_layers_jax_shards(model, tiny_flux, tiny_unet):
    """The counterpart of tests/test_tp.py:46: the port's rules split the
    same layers, name for name, as JAX's rules split kernels."""
    if model == "flux":
        _, params, tmodel, _ = tiny_flux
        rules, jrules = tp.FLUX_TP_RULES, jtp.FLUX_TP_RULES
        tmodel = tflux.FluxTransformer(tflux.FluxConfig.tiny(), device="cpu")
    else:
        _, params, tmodel, _ = tiny_unet
        rules, jrules = tp.UNET_TP_RULES, jtp.UNET_TP_RULES
        tmodel = type(tmodel)(tmodel.cfg, device="cpu")
    report = tp.shard_module_by_rules(_fake_mesh(2), tmodel, rules)
    want = _jax_sharded_layers(params, jrules, 2)
    assert want and _port_sharded_layers(report) == want
    assert not report["replicated"]


def test_divisibility_fallback_replicates():
    """The counterpart of tests/test_tp.py:57: a dim that does not divide
    tp keeps the layer whole; so does an int8 slice off a multiple of 8 and
    an int4 row slice that would cut a scale group."""
    module = nn.Module()
    module.attn_to_q = nn.Linear(6, 6)  # 6 % 8 != 0
    report = tp.shard_module_by_rules(_fake_mesh(8), module, tp.FLUX_TP_RULES)
    assert report["replicated"] == ["attn_to_q"] and isinstance(module.attn_to_q, nn.Linear)
    int8 = nn.Module()
    int8.attn_to_q = Int8Linear(16, 24)  # 12 output rows per rank: not the GEMM's multiple of 8
    report = tp.shard_module_by_rules(_fake_mesh(2), int8, tp.FLUX_TP_RULES)
    assert report["replicated"] == ["attn_to_q"] and isinstance(int8.attn_to_q, Int8Linear)
    q = nn.Module()
    q.attn_to_out_0 = Int4Linear(256, 16)  # 2 groups of 128 rows
    assert tuple(q.attn_to_out_0.kernel_scale.shape) == (2, 16)
    report = tp.shard_module_by_rules(_fake_mesh(4), q, tp.FLUX_TP_RULES)
    assert report["replicated"] == ["attn_to_out_0"]
    report = tp.shard_module_by_rules(_fake_mesh(2), q, tp.FLUX_TP_RULES)
    assert report[tp.ROW] == ["attn_to_out_0"]


def _quantized_tiny(bits):
    import dataclasses

    tmodel = tflux.FluxTransformer(tflux.FluxConfig.tiny(), device="cpu")
    field = "quant_int4" if bits == 4 else "quant_int8"
    qcfg = dataclasses.replace(tmodel.cfg, **{field: True})
    return quantize_like(tflux.FluxTransformer(qcfg, device="meta"), tmodel)


@pytest.mark.parametrize("rank", [0, 1])
def test_int8_scale_follows_kernel(rank):
    """The counterpart of tests/test_tp.py:114's placement: the port's int8
    kernel is [out, in], so a column split cuts its rows and kernel_scale
    with them; a row split cuts its columns and keeps the scale whole."""
    full = _quantized_tiny(8)
    blk = full.transformer_blocks[0]
    q_kernel, q_scale = blk.attn_to_q.kernel.clone(), blk.attn_to_q.kernel_scale.clone()
    o_kernel, o_scale = blk.attn_to_out_0.kernel.clone(), blk.attn_to_out_0.kernel_scale.clone()
    tp.shard_module_by_rules(_fake_mesh(2, rank), full, tp.FLUX_TP_RULES)
    half = slice(rank * 24, (rank + 1) * 24)
    col, row = blk.attn_to_q, blk.attn_to_out_0
    assert isinstance(col, tp.ColumnParallel) and isinstance(row, tp.RowParallel)
    assert torch.equal(col.local.kernel, q_kernel[half])
    assert torch.equal(col.local.kernel_scale, q_scale[half])
    assert torch.equal(row.local.kernel, o_kernel[:, half])
    assert torch.equal(row.local.kernel_scale, o_scale)


@pytest.mark.parametrize("rank", [0, 1])
def test_int4_packed_and_group_scales_follow_kernel(rank):
    """The counterpart of tests/test_tp.py:81's placement: kernel_packed
    [in // 2, out] and kernel_scale [groups, out] split dim for dim with
    the kernel: whole bytes, and whole groups or the one group kept whole."""
    full = _quantized_tiny(4)
    blk = full.transformer_blocks[0]
    q_packed, q_scale = blk.attn_to_q.kernel_packed.clone(), blk.attn_to_q.kernel_scale.clone()
    o_packed, o_scale = (blk.attn_to_out_0.kernel_packed.clone(),
                         blk.attn_to_out_0.kernel_scale.clone())
    assert o_scale.shape[0] == 1  # 48 input rows: one group
    tp.shard_module_by_rules(_fake_mesh(2, rank), full, tp.FLUX_TP_RULES)
    half = slice(rank * 24, (rank + 1) * 24)
    assert torch.equal(blk.attn_to_q.local.kernel_packed, q_packed[:, half])
    assert torch.equal(blk.attn_to_q.local.kernel_scale, q_scale[:, half])
    assert torch.equal(blk.attn_to_out_0.local.kernel_packed, o_packed[rank * 12:(rank + 1) * 12])
    assert torch.equal(blk.attn_to_out_0.local.kernel_scale, o_scale)
    grouped = nn.Module()
    grouped.attn_to_out_0 = Int4Linear(256, 16)
    grouped.attn_to_out_0.kernel_scale = torch.arange(32.0).reshape(2, 16)
    tp.shard_module_by_rules(_fake_mesh(2, rank), grouped, tp.FLUX_TP_RULES)
    local = grouped.attn_to_out_0.local
    assert tuple(local.kernel_packed.shape) == (64, 16)
    assert torch.equal(local.kernel_scale, torch.arange(32.0).reshape(2, 16)[rank:rank + 1])


# -------------------------------------------------------------- forwards
@pytest.mark.parametrize("variant", ["flux_f32", "flux_int8", "flux_int4", "unet"])
def test_tp_forward_matches_unsharded(variant, two_ranks):
    """The counterpart of tests/test_tp.py:30 (and the forwards of :81 and
    :114): a TP-2 forward equals the unsharded one on both ranks."""
    for out in two_ranks:
        run = out["forwards"][variant]
        assert run["report"][tp.COLUMN] and run["report"][tp.ROW]
        np.testing.assert_allclose(run["tp"], run["ref"], **SPLIT_TOL)


@pytest.mark.parametrize("model", ["flux", "unet"])
def test_tp_forward_matches_jax_sharded(model, two_ranks, tiny_flux, tiny_unet):
    """The port's TP-2 forward against JAX's shard_params_by_rules forward
    on a (1, 2) mesh with the same weights and inputs."""
    if model == "flux":
        jmod, params, _, args = tiny_flux
        want, tol = _jax_tp_forward(jmod, params, args, jtp.FLUX_TP_RULES), DIT_TOL
        got = two_ranks[0]["forwards"]["flux_f32"]["tp"]
    else:
        jmod, params, _, args = tiny_unet
        want, tol = _jax_tp_forward(jmod, params, args, jtp.UNET_TP_RULES), MODEL_TOL
        got = two_ranks[0]["forwards"]["unet"]["tp"]
    np.testing.assert_allclose(got, want, **tol)


def test_contiguous_splits_break_the_output(two_ranks):
    """GEGLU's [h | gate] and the single-stream proj_out's [attn | mlp] input
    split contiguously give another function; an adaLN modulation split
    without its gather cannot run (its chunks modulate the full width)."""
    for out in two_ranks:
        broken = out["forwards"]["broken"]
        assert broken["flux_proj_out"] > 1e-2
        assert broken["unet_geglu"] > 1e-2
        assert broken["flux_adaln_raises"]


def test_tp_collectives_per_forward(two_ranks):
    """One all_reduce per row-parallel pair of a double block (image and
    text together), per single block and for the final projection; one
    all_gather per adaLN modulation; int8 row splits add one MAX
    all_reduce of the activation scales each."""
    cfg = tflux.FluxConfig.tiny()
    n_d, n_s = cfg.num_double_blocks, cfg.num_single_blocks
    fwd = two_ranks[0]["forwards"]
    assert fwd["flux_f32"]["counts"] == {"all_reduce": 2 * n_d + n_s + 1,
                                         "all_gather": 2 * n_d + n_s + 1}
    assert fwd["flux_int8"]["counts"]["all_reduce_max"] == 4 * n_d + n_s
    unet_rows = len(fwd["unet"]["report"][tp.ROW])
    assert fwd["unet"]["counts"] == {"all_reduce": unet_rows}


def test_mesh_layout_2d_matches_jax(grid_ranks):
    """rank = data_rank * tp + model_rank, JAX's device order of a (2, 2)
    mesh."""
    devices = jmesh.make_mesh(num_devices=4, axis_shape=(2, 2),
                              axis_names=(jmesh.DATA_AXIS, jmesh.MODEL_AXIS)).devices
    for rank, out in enumerate(grid_ranks):
        d, m, data_ranks, model_ranks = out["layout"]
        assert devices[d, m].id == rank
        assert data_ranks == [devices[i, m].id for i in range(2)]
        assert model_ranks == [devices[d, i].id for i in range(2)]


# ---------------------------------------------------------------- serving
def test_sharded_engine_matches_unsharded(two_ranks):
    """The counterpart of tests/test_serve.py:248: 4 deterministic requests
    in ONE batch over 2 data ranks, bit-equal to the unsharded engine; a
    partial batch pads and still shards."""
    serve = two_ranks[0]["serving"]
    with InferenceEngine(workers.sd_serving_pipeline(policy=True), batch_size=4, latent_size=8,
                         flush_ms=300.0) as single:
        futs = [single.submit(workers.gen_request(i, deterministic=True)) for i in range(4)]
        want = [f.result(timeout=120) for f in futs]
    assert serve["batches"] == 1
    for got, ref in zip(serve["sharded"], want, strict=True):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(serve["partial"], serve["sharded"][0])
    assert any(not np.array_equal(serve["sharded"][0], s) for s in serve["sharded"][1:])


def test_mesh_batch_size_must_divide(two_ranks):
    """The counterpart of tests/test_serve.py:291 on a real 2-rank mesh."""
    for out in two_ranks:
        assert re.search("must divide", out["serving"]["divide_error"])


def test_sharded_engine_follows_hot_reload(two_ranks):
    """A hot reload on rank 0 reaches the followers with the next batch."""
    serve = two_ranks[0]["serving"]
    with InferenceEngine(workers.sd_serving_pipeline(policy=True), batch_size=4, latent_size=8,
                         flush_ms=50.0) as single:
        single.update_factor_params({k: torch.as_tensor(v)
                                     for k, v in serve["reload_state"].items()})
        want = single.generate(workers.gen_request(1, deterministic=True), timeout=120)
    np.testing.assert_array_equal(serve["reloaded"], want)
    assert not np.array_equal(serve["reloaded"], serve["sharded"][1])


def _unsharded_edits(key):
    with EditInferenceEngine(workers.edit_serving_pipeline(), batch_size=EDIT_BATCH[key],
                             flush_ms=300.0, **workers.EDIT_KW) as single:
        futs = [single.submit(workers.edit_request(i, deterministic=True))
                for i in EDIT_ROWS[key]]
        return [f.result(timeout=120) for f in futs]


def test_edit_mesh_sharded_matches_unsharded(two_ranks):
    """The counterpart of tests/test_serve.py:414: deterministic edits over
    2 data ranks in one batch, bit-equal to the unsharded engine."""
    edit = two_ranks[0]["edit_dp"]
    assert edit["batches"] == 1 and edit["split"] == 0
    for got, ref in zip(edit["images"], _unsharded_edits("dp"), strict=True):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_edit_tp_mesh_serving(mesh, two_ranks, grid_ranks):
    """The counterpart of tests/test_serve.py:435: the DiT splits over the
    model group (and the batch over the data ranks on 2 x 2); within one
    uint8 step of the unsharded edit."""
    key, ranks = ("tp", two_ranks) if mesh == "1x2" else ("grid", grid_ranks)
    edit = ranks[0]["edit_tp"]
    assert all(out["edit_tp"]["split"] > 0 for out in ranks)
    for got, ref in zip(edit["images"], _unsharded_edits(key), strict=True):
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1, f"TP image deviates: max abs diff {diff.max()}"


# --------------------------------------------------------------- trainers
def test_edit_trainer_mesh_matches_single_device(two_ranks, base, tmp_path):  # noqa: F811
    """The counterpart of tests/test_train_edit.py:94: EditPPOTrainer over 2
    data ranks (num_groups resolved to 2) gives the one-process trainer's
    rollout rewards; its parameters are bit-equal across ranks."""
    _, tpipe = _edit_pipelines(base)
    _, cfg = _edit_configs(num_groups=2, output_dir=str(tmp_path))
    single = EditPPOTrainer(tpipe, tmetrics.image_psnr_reward, cfg)
    want = single.train_step(_edit_batch(rows=4))
    for out in two_ranks:
        t = out["edit_trainer"]
        assert t["num_groups"] == 2 and t["tp_report"] is None
        assert t["metrics"]["num_inference"] == want["num_inference"]
        for name in ("reward", "baseline_reward"):
            np.testing.assert_allclose(t["metrics"][name], want[name], rtol=1e-4, err_msg=name)
        assert all(np.isfinite(v).all() for v in t["params"].values())
    for name, value in two_ranks[1]["edit_trainer"]["params"].items():
        np.testing.assert_array_equal(value, two_ranks[0]["edit_trainer"]["params"][name])


def test_edit_trainer_2d_mesh_tp(grid_ranks, two_ranks):
    """The counterpart of tests/test_train_edit.py:137: a 2 x 2 mesh, the
    frozen DiT split over each model group while the batch splits over the
    data ranks; finite, and the rewards of the 2 x 1 run."""
    ref = two_ranks[0]["edit_trainer"]["metrics"]
    for out in grid_ranks:
        t = out["edit_trainer"]
        report = t["tp_report"]
        assert report[tp.COLUMN] and report[tp.ROW] and report[tp.GATHERED]
        assert np.isfinite(t["metrics"]["loss"]) and np.isfinite(t["metrics"]["reward"])
        np.testing.assert_allclose(t["metrics"]["reward"], ref["reward"], rtol=0, atol=2e-3)
    assert len({out["edit_trainer"]["param_sum"] for out in grid_ranks}) == 1


def test_no_port_module_waits_for_data_parallelism():
    """Data parallelism is wired through the trainers, the update, the
    engines and the eval: no port module names its roadmap item any more."""
    from pathlib import Path

    root = Path(ttrain.__file__).resolve().parent.parent
    assert not [str(p) for p in root.rglob("*.py") if "A.15" in p.read_text()]
