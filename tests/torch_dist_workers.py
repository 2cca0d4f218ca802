"""Helpers of the port's distributed tests (no JAX here: the spawned ranks
import this module).

``world1_mesh`` joins a one-rank gloo group in the test process itself, for
tests that drive a mesh path without spawning; the ``*_rank`` functions run
in processes started by :func:`consolver_torch.dist.launch.spawn`.
"""

from __future__ import annotations

import contextlib
import os
import pickle

import torch
import torch.distributed as dist

from consolver_torch.dist import mesh as meshlib
from consolver_torch.dist.launch import free_port


@contextlib.contextmanager
def world1_mesh():
    """A 1 x 1 data mesh over a one-rank gloo group on the CPU."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    try:
        yield meshlib.init_mesh(1, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cpu_mesh(dp: int, tp: int = 1) -> meshlib.Mesh:
    """The spawned rank's ``dp x tp`` mesh on the CPU."""
    return meshlib.init_mesh(dp, tp, device="cpu")


def to_numpy(tree):
    """Tensors of a result tree as numpy arrays (pickled back by value)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


# ------------------------------------------------------------ data parallel
def _sd_pipeline(models):
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.pipelines.t2i import TextToImagePipeline

    unet, text, vae, net = models
    return TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=net,
                               device="cpu")


def inject_actions(net, actions, rows=None):
    """``net`` replays ``actions`` ``[B, S-1, A]`` (its ``rows`` only) at
    steps >= 1, the mode at step 0 (dropped from the trajectory), with its
    own probabilities of them; returns the step counter."""
    step = {"i": 0}

    def sample_action(conds, generator=None):
        i = step["i"]
        step["i"] = i + 1
        if i == 0:
            return net.mode_action(conds)
        chosen = torch.as_tensor(actions[rows if rows is not None else slice(None), i - 1])
        probs, _ = net.get_action_probs(conds, chosen)
        return chosen, probs

    net.sample_action = sample_action
    return step


def _rollouts(mesh, p):
    """The tiny SD program over this shard, mode and sampled actions, gathered."""
    from consolver_torch.policy.factor_net import ShardedGenerator

    pipe = _sd_pipeline(p["models"])
    ids, noise = p["ids"], p["noise"]
    rows = meshlib.shard_slice(mesh, len(noise))
    out = {}
    for name, kw in (("mode", dict(deterministic_policy=True)),
                     ("sampled", dict(generator=ShardedGenerator(
                         torch.Generator().manual_seed(3), rows.start, len(noise))))):
        kw.setdefault("generator", None)
        latents, traj = pipe(kw.pop("generator"), ids[rows], noise[rows], num_inference_steps=3,
                             guidance_scale=3.0, decode=False, **kw)
        out[name] = meshlib.gather_batch(mesh, {"latents": latents, "actions": traj.actions})
    return out


def _dp_update(mesh, p):
    """One data-parallel PPO update on this shard of a padded batch."""
    from consolver_torch.rl import ppo

    net = pickle.loads(p["net"])
    opt = ppo.make_optimizer(net, ppo.PPOConfig(learning_rate=1e-3, entropy_coef=0.01))
    update = ppo.make_update_fn(net, opt, opt.config, grad_sync=meshlib.make_grad_sync(mesh))
    conds, actions, old, adv, valid = meshlib.shard_batch(
        mesh, tuple(torch.from_numpy(p[k]) for k in ("x", "actions", "old", "adv", "valid")))
    aux = update({"x": conds}, actions, old, adv, valid)
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": {n: q.grad.clone() for n, q in net.named_parameters()},
            "params": {n: q.detach().clone() for n, q in net.named_parameters()},
            "valid_rows": float(valid.sum()),
            "param_sum": meshlib.assert_params_synced(net, mesh)}


def _trainers(mesh, p):
    """One PPO step of the DP trainer sampling its own actions, one with the
    JAX actions injected, and rank-0 checkpoint gating with a resume."""
    from consolver_torch.rewards.registry import make_reward_fn
    from consolver_torch.rl import ppo
    from consolver_torch.rl import train as ttrain

    def trainer(output_dir):
        cfg = ttrain.TrainConfig(**p["train_fields"], output_dir=output_dir,
                                 ppo=ppo.PPOConfig(ppo_epochs=1, learning_rate=1e-3))
        models = pickle.loads(p["models_blob"])
        return ttrain.PPOTrainer(_sd_pipeline(models), make_reward_fn("image_psnr"), cfg,
                                 mesh=mesh)

    out = {}
    sampled = trainer(os.path.join(p["tmp"], "sampled"))
    metrics = sampled.train_step(dict(p["batch"]))
    out["sampled"] = {"metrics": metrics, "num_groups": sampled.num_groups,
                      "params": {n: q.detach().clone()
                                 for n, q in sampled.factor_net.named_parameters()}}
    injected = trainer(os.path.join(p["tmp"], "injected"))
    rows = meshlib.shard_slice(mesh, len(p["batch"]["noise"]))
    steps = inject_actions(injected.factor_net, p["jax_actions"], rows)
    metrics = injected.train_step(dict(p["batch"]))
    out["injected"] = {"metrics": metrics, "steps": steps["i"],
                       "grads": {n: q.grad.clone()
                                 for n, q in injected.factor_net.named_parameters()},
                       "params": {n: q.detach().clone()
                                  for n, q in injected.factor_net.named_parameters()}}
    # checkpoint gating: rank 0 writes, every rank resumes the same state
    path = sampled.save_checkpoint()
    out["ckpt_exists"] = os.path.isdir(path)
    fresh = trainer(os.path.join(p["tmp"], "sampled"))
    out["resumed"] = fresh.resume_from_checkpoint("latest")
    out["resumed_step"] = fresh.global_step
    out["resumed_equal"] = all(torch.equal(a, b) for a, b in zip(
        fresh.factor_net.parameters(), sampled.factor_net.parameters(), strict=True))
    out["counts"] = [fresh._num_inference_for_step(s) for s in range(12)]
    out["param_sum"] = fresh.param_sum()
    return out


def _eval(mesh, p):
    from consolver_torch.eval.consistency import evaluate_consistency
    from consolver_torch.rewards.registry import make_reward_fn

    psnr = make_reward_fn("image_psnr")

    def fails_on_one_rank(gen, ref):  # as an out-of-memory on one rank's whole chunk
        if mesh.data_rank == 1 and gen.shape[0] > 1:
            raise RuntimeError("out of memory on data rank 1")
        return psnr(gen, ref)

    return {name: evaluate_consistency(fn, p["gen_dir"], p["ref_dir"], batch_size=16, mesh=mesh)
            for name, fn in (("psnr", psnr), ("one_rank_fault", fails_on_one_rank))}


def _mesh_config_and_hybrid(n: int):
    """mesh_from_config's clamping and the hybrid mesh's fallback, on n ranks."""
    out, warnings = {}, []
    out["1x1"] = meshlib.mesh_from_config(1, 1) is None
    for name, (d, m) in {"nx1": (n, 1), "half_x2": (n // 2, 2), "64x1": (64, 1),
                         "nx3": (n, 3)}.items():
        warnings.clear()
        mesh = meshlib.mesh_from_config(d, m, warn=warnings.append, device="cpu")
        out[name] = (mesh.shape, len(warnings))
    hybrid = meshlib.make_hybrid_mesh(ici_shape=(1, 2), dcn_shape=(n // 2, 1), device="cpu")
    x = meshlib.shard_batch(hybrid, torch.arange(8.0).reshape(n // 2, -1))
    out["hybrid"] = (hybrid.shape, float(hybrid.all_reduce((x * 2).sum(), "data")))
    refused = []
    for ici, dcn in (((n // 2, 1), (1, 2)), ((1, 2 * n), (1, 1))):  # model axis across nodes
        try:
            meshlib.make_hybrid_mesh(ici_shape=ici, dcn_shape=dcn, device="cpu")
        except ValueError as e:
            refused.append("across nodes" in str(e))
    out["hybrid_refused"] = refused
    return out


def fails_on_rank_one(rank: int) -> int:
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def dp_suite_rank(rank: int, payload: bytes) -> dict:
    """Every data-parallel case of ``tests/test_torch_dist.py`` on one rank."""
    torch.set_num_threads(1)  # tiny models; several ranks share the host's cores
    p = pickle.loads(payload)
    p["models"] = pickle.loads(p["models_blob"])
    mesh = cpu_mesh(p["dp"])
    out = {"layout": {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
                      "data_ranks": dist.get_process_group_ranks(mesh.data_group),
                      "model_ranks": dist.get_process_group_ranks(mesh.model_group),
                      "shape": mesh.shape, "backend": mesh.backend}}
    with torch.no_grad():
        out["rollouts"] = _rollouts(mesh, p)
    out["update"] = _dp_update(mesh, p["update"])
    out["trainers"] = _trainers(mesh, p)
    out["eval"] = _eval(mesh, p)
    out["config"] = _mesh_config_and_hybrid(p["dp"])
    return to_numpy(out)



# ---------------------------------------------------------- tensor parallel
def _fill(module, gen, std=0.1):
    with torch.no_grad():
        for q in module.parameters():
            q.normal_(0.0, std, generator=gen)
    return module


def sd_serving_pipeline(policy: bool, seed: int = 1):
    """The tiny SD stack of the serving tests, from a seed (torch only)."""
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    gen = torch.Generator().manual_seed(seed)
    models = [UNet2DCondition(UNetConfig.tiny(), device="cpu"),
              ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"),
              AutoencoderKL(VaeConfig.tiny(), device="cpu")]
    net = None
    if policy:
        net = FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, num_actions=11, family="sd"),
                        device="cpu")
        models.append(net)
    for m in models:
        _fill(m, gen)
    return TextToImagePipeline(*models[:3], DiffusionSchedule.sd15(), factor_net=net, device="cpu")


def edit_serving_pipeline(seed: int = 0):
    """The tiny FLUX-Kontext stack of the serving tests, from a seed."""
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.edit import FluxKontextPipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

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
        _fill(m, gen)
    return FluxKontextPipeline(*models, factor_net=policy, device="cpu")


def gen_request(i: int, **kw):
    from consolver_torch.serve.engine import GenerationRequest

    kw.setdefault("num_inference_steps", 2)
    return GenerationRequest(prompt=f"prompt {i}", seed=100 + i, **kw)


def edit_request(i: int, **kw):
    import numpy as np

    from consolver_torch.serve.engine import EditRequest

    kw.setdefault("num_inference_steps", 2)
    image = np.random.default_rng(i).integers(0, 256, (24, 20, 3), np.uint8)
    return EditRequest(instruction=f"edit {i}", image=image, seed=200 + i, **kw)


EDIT_KW = dict(resolution=16, t5_max_length=4, clip_max_length=4)


def _tp_forwards(mesh, p):
    """The tiny FLUX (f32, int8, int4) and UNet forwards split over the model
    group, with their unsharded outputs, reports and collective counts."""
    import copy
    import dataclasses

    from consolver_torch.dist import tp
    from consolver_torch.kernels.quant import quantize_like
    from consolver_torch.models.flux import FluxTransformer

    flux, flux_args = pickle.loads(p["flux"])
    unet, unet_args = pickle.loads(p["unet"])
    variants = {"flux_f32": (copy.deepcopy(flux), flux_args, tp.FLUX_TP_RULES),
                "unet": (copy.deepcopy(unet), unet_args, tp.UNET_TP_RULES)}
    for bits, field in ((8, "quant_int8"), (4, "quant_int4")):
        qcfg = dataclasses.replace(flux.cfg, **{field: True})
        variants[f"flux_int{bits}"] = (quantize_like(FluxTransformer(qcfg, device="meta"),
                                                     copy.deepcopy(flux)), flux_args,
                                       tp.FLUX_TP_RULES)
    out = {}
    for name, (model, args, rules) in variants.items():
        ref = model(*args)
        report = tp.shard_module_by_rules(mesh, model, rules)
        tp.stats.reset()
        got = model(*args)
        out[name] = {"ref": ref, "tp": got, "report": report, "counts": dict(tp.stats.counts)}
    # the same splits without the declared parts (contiguous) or without the gather
    broken = {}
    model = copy.deepcopy(flux)
    for block in model.single_transformer_blocks:
        del block.proj_out.tp_parts
    tp.shard_module_by_rules(mesh, model, tp.FLUX_TP_RULES)
    broken["flux_proj_out"] = (model(*flux_args) - out["flux_f32"]["ref"]).abs().max()
    model = copy.deepcopy(unet)
    for name, layer in model.named_modules():
        if name.endswith("ff.net.0.proj"):
            del layer.tp_parts
    tp.shard_module_by_rules(mesh, model, tp.UNET_TP_RULES)
    broken["unet_geglu"] = (model(*unet_args) - out["unet"]["ref"]).abs().max()
    model = copy.deepcopy(flux)
    ungathered = [(pat, tp.COLUMN if kind == tp.GATHERED else kind)
                  for pat, kind in tp.FLUX_TP_RULES]
    tp.shard_module_by_rules(mesh, model, ungathered)
    try:
        model(*flux_args)
        broken["flux_adaln_raises"] = False
    except RuntimeError:
        broken["flux_adaln_raises"] = True
    out["broken"] = broken
    return out


def _serving(mesh, p):
    """The SD engine over the data ranks (one batch; a partial one; a hot
    reload), and the batch-divisibility check on a real mesh."""
    from consolver_torch.serve.engine import InferenceEngine

    out = {}
    pipe = sd_serving_pipeline(policy=True)
    try:
        InferenceEngine(pipe, batch_size=3, latent_size=8, mesh=mesh)
    except ValueError as err:
        out["divide_error"] = str(err)
    eng = InferenceEngine(pipe, batch_size=4, latent_size=8, mesh=mesh, flush_ms=300.0)
    if mesh.is_primary:
        futs = [eng.submit(gen_request(i, deterministic=True)) for i in range(4)]
        out["sharded"] = [f.result(timeout=120) for f in futs]
        out["batches"] = eng.stats()["batches"]
        out["partial"] = eng.generate(gen_request(0, deterministic=True), timeout=120)
        state = {k: v + 0.05 for k, v in pipe.factor_net.state_dict().items()}
        eng.update_factor_params(state)
        out["reloaded"] = eng.generate(gen_request(1, deterministic=True), timeout=120)
        out["reload_state"] = state
    eng.shutdown()
    return out


def _edit_serving(mesh, p, key):
    from consolver_torch.dist import tp
    from consolver_torch.serve.engine import EditInferenceEngine

    out = {}
    eng = EditInferenceEngine(edit_serving_pipeline(), batch_size=p["edit_batch"][key],
                              flush_ms=300.0, mesh=mesh, **EDIT_KW)
    if mesh.is_primary:
        futs = [eng.submit(edit_request(i, deterministic=True)) for i in p["edit_rows"][key]]
        out["images"] = [f.result(timeout=120) for f in futs]
        out["batches"] = eng.stats()["batches"]
    out["split"] = sum(isinstance(m, (tp.ColumnParallel, tp.RowParallel))
                       for m in eng.pipeline.transformer.modules())
    eng.shutdown()
    return out


def _edit_trainer(mesh, p):
    from consolver_torch.rewards import metrics
    from consolver_torch.rl import ppo
    from consolver_torch.rl import train as ttrain
    from consolver_torch.rl.train_edit import EditPPOTrainer

    cfg = ttrain.TrainConfig(**p["edit_train_fields"], output_dir=os.path.join(p["tmp"], "edit"),
                             ppo=ppo.PPOConfig(ppo_epochs=1, learning_rate=1e-3,
                                               advantage_scale=1.0))
    trainer = EditPPOTrainer(pickle.loads(p["edit_pipe"]), metrics.image_psnr_reward, cfg,
                             mesh=mesh)
    metrics_out = trainer.train_step(dict(p["edit_batch_rows"]))
    return {"metrics": metrics_out, "num_groups": trainer.num_groups,
            "tp_report": trainer.tp_report,
            "param_sum": trainer.param_sum(),
            "params": {n: q.detach().clone() for n, q in trainer.factor_net.named_parameters()}}


def tp_suite_rank(rank: int, payload: bytes) -> dict:
    """Every case of ``tests/test_torch_tp.py`` on one rank of two (or, with
    ``p["grid"]``, of a 2 x 2 mesh)."""
    torch.set_num_threads(1)
    p = pickle.loads(payload)
    out = {}
    if p.get("grid"):
        mesh = cpu_mesh(2, 2)
        out["layout"] = (mesh.data_rank, mesh.model_rank,
                         dist.get_process_group_ranks(mesh.data_group),
                         dist.get_process_group_ranks(mesh.model_group))
        out["edit_trainer"] = _edit_trainer(mesh, p)
        out["edit_tp"] = _edit_serving(mesh, p, "grid")
        return to_numpy(out)
    tp_mesh, dp_mesh = cpu_mesh(1, 2), cpu_mesh(2)
    with torch.no_grad():
        out["forwards"] = _tp_forwards(tp_mesh, p)
    out["serving"] = _serving(dp_mesh, p)
    out["edit_dp"] = _edit_serving(dp_mesh, p, "dp")
    out["edit_tp"] = _edit_serving(tp_mesh, p, "tp")
    out["edit_trainer"] = _edit_trainer(dp_mesh, p)
    return to_numpy(out)


# ------------------------------------------------------------------ the card
def tp_flux_on_card_rank(rank: int, blob: bytes) -> dict:
    """A tiny f32 DiT split over two ranks on the card (TF32 off)."""
    from consolver_torch.dist import tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, args = pickle.loads(blob)
    mesh = meshlib.init_mesh(1, 2, device="cuda")
    model = model.to(mesh.device)
    tp.shard_module_by_rules(mesh, model, tp.FLUX_TP_RULES)
    with torch.no_grad():
        out = model(*(a.to(mesh.device) for a in args))
    return {"out": out.cpu().numpy(), "device": str(out.device), "backend": mesh.backend}


def card_collectives_rank(rank: int) -> dict:
    """all_reduce / all_gather / broadcast of CUDA tensors over the world."""
    mesh = meshlib.init_mesh(int(os.environ["WORLD_SIZE"]), device="cuda")
    x = mesh.all_reduce(torch.full((3,), float(rank + 1), device=mesh.device))
    gathered = mesh.all_gather(torch.tensor([float(rank)], device=mesh.device), "world")
    sent = mesh.broadcast(torch.full((2,), float(rank + 5), device=mesh.device))
    return {"sum": x.tolist(), "gathered": gathered.tolist(), "broadcast": sent.tolist(),
            "device": str(x.device), "backend": mesh.backend}


def cli_dp_rank(rank: int, commands):
    """Each command line of ``commands`` through ``consolver_torch.__main__``
    on this rank of the spawned world (one intra-op thread a rank); returns
    their exit codes."""
    from consolver_torch.__main__ import main

    torch.set_num_threads(1)
    return [main(list(argv)) for argv in commands]


def serve_mesh_rank(rank: int) -> dict:
    """``serve``'s mesh flags on this rank of a 2-rank world: the meshes
    ``--shard`` / ``--tp`` make, the flags refused, then ``--shard`` serving
    one request through rank 0's engine while rank 1 follows."""
    import argparse

    from consolver_torch.cli import serve as cli_serve
    from consolver_torch.serve import GenerationRequest

    torch.set_num_threads(1)
    cpu = torch.device("cpu")

    def ns(**kw):
        return argparse.Namespace(**{"shard": False, "tp": 1, **kw})

    out = {"none": cli_serve._serving_mesh(ns(), cpu)}
    for name, kw in (("shard", dict(shard=True)), ("tp2", dict(tp=2)),
                     ("shard_tp2", dict(shard=True, tp=2))):
        mesh = cli_serve._serving_mesh(ns(**kw), cpu)
        out[name] = (mesh.shape, cli_serve._data_shards(mesh))
    for name, kw in (("tp3", dict(tp=3)),):
        try:
            cli_serve._serving_mesh(ns(**kw), cpu)
        except SystemExit as e:
            out[name] = str(e)
    args = cli_serve._parser().parse_args(
        ["--family", "sd", "--shard", "--batch-size", "1", "--port", "0", "--flush-ms", "5",
         "--device", "cpu"])
    server, engines, descs = cli_serve.build_server(args)
    out["descs"] = descs
    if rank == 0:
        image = engines[0].generate(GenerationRequest(prompt="mesh", seed=3,
                                                      num_inference_steps=2), timeout=120)
        out["image"] = image
        engines[0].shutdown()
        server.server_close()
    else:
        out["server"] = server
        engines[0].join()
    both = cli_serve._parser().parse_args(["--family", "both", "--shard", "--device", "cpu"])
    try:
        cli_serve.build_server(both)
    except SystemExit as e:
        out["both"] = str(e)
    return out
