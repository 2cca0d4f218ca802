"""Production serving: ``python -m consolver_torch serve``.

Port of ``scripts/serve.py``: a resident micro-batching HTTP server over the
engines of ``consolver_torch/serve``::

  # text-to-image (SD family)
  python -m consolver_torch serve --pretrained ckpts/sd15 \\
      [--factor-ckpt runs/ppo/checkpoint-3000] [--quantize] [--port 8000]

  # instructional editing (FLUX-Kontext family)
  python -m consolver_torch serve --family edit --pretrained ckpts/flux \\
      [--quantize --quantize-bits 4] [--resolution 1024]

  # both engines in one process
  python -m consolver_torch serve --family both --pretrained ckpts/sd15 \\
      --edit-pretrained ckpts/flux --batch-sizes 1,8 --adaptive-flush --prewarm 8

Pipelines load through ``cli/train_sd15.build_pipeline`` and
``cli/train_flux.build_pipeline`` from converted or quantized component
directories; without ``--pretrained`` the tiny random models of smoke mode
serve.  Multi-card modes: ``--replicas N`` (one engine per card, each with
its own model copy), or ``--shard`` / ``--tp N`` over a ``torchrun`` world
(``dist.mesh``: ``--shard`` makes every rank a data rank, ``--tp N`` splits
the denoiser over N ranks; without ``--shard`` the world must hold exactly N
ranks).  Rank 0 serves HTTP; the other ranks follow its batches.  SIGTERM
drains like Ctrl-C: the batch being collected or already dispatched
completes, and requests still queued behind it are answered with an
``EngineShutDown`` error (HTTP 500) before the process exits.  ``--compile-cache`` is accepted for the JAX CLI's command
lines and ignored: the port has no compiled programs to cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from consolver_torch.configs.config import ExperimentConfig, add_device_flag, apply_overrides
from consolver_torch.device import resolve_device


def _parser():
    ap = argparse.ArgumentParser(prog="python -m consolver_torch serve")
    ap.add_argument("--family", choices=("sd", "edit", "both"), default="sd",
                    help="sd = /v1/generate (SD-1.5 class); edit = /v1/edit (FLUX-Kontext); "
                         "both = the two engines in one process (--pretrained then points at "
                         "the SD checkpoint and --edit-pretrained at the FLUX one)")
    ap.add_argument("--edit-pretrained", default=None,
                    help="[both] FLUX checkpoint dir (smoke models if unset)")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--factor-ckpt", default=None)
    ap.add_argument("--quantize", action="store_true",
                    help="serve the quantized path (pipeline.quantize())")
    ap.add_argument("--quantize-bits", type=int, default=8, choices=(4, 8),
                    help="with --quantize on the edit family: 8 = W8A8 int8, 4 = packed "
                         "int4 DiT weights (W4A16)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="largest batch shape (default: 8 sd, 1 edit); per data rank with "
                         "--shard")
    ap.add_argument("--shard", action="store_true",
                    help="serve over a data mesh of every rank of the torchrun world")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve N independent single-card replicas with least-loaded "
                         "dispatch; exclusive with --shard / --tp")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size: tensor-shard the denoiser over this many ranks")
    ap.add_argument("--latent-size", type=int, default=None,
                    help="[sd] latent H=W (default: 64 with --pretrained, 8 smoke)")
    ap.add_argument("--resolution", type=int, default=None,
                    help="[edit] image H=W (default: 1024 with --pretrained, 16 smoke)")
    ap.add_argument("--t5-max-length", type=int, default=128)
    ap.add_argument("--padded-max-steps", type=int, default=None,
                    help="serve any step count in [1, N] of the learnable solver from one "
                         "pad-to-max program")
    ap.add_argument("--prewarm", nargs="*", type=int, metavar="STEPS", default=None,
                    help="run each serving program once before binding the port: bare "
                         "--prewarm warms the default step count, --prewarm 5 8 one program "
                         "per listed count")
    ap.add_argument("--prewarm-refine", dest="prewarm_refine", action="store_true",
                    help="also warm the refine programs (/v1/refine, /v1/edit/refine)")
    ap.add_argument("--flush-ms", type=float, default=30.0,
                    help="partial-batch flush window; with --adaptive-flush its cap")
    ap.add_argument("--batch-sizes", default=None,
                    help="comma-separated batch shapes per data rank (e.g. '1,8'): a partial "
                         "batch pads to the smallest that fits")
    ap.add_argument("--adaptive-flush", action="store_true",
                    help="scale the flush window with the observed arrival rate")
    ap.add_argument("--max-wait-s", type=float, default=None,
                    help="queue deadline: requests waiting longer are failed 503")
    ap.add_argument("--request-timeout", type=float, default=600.0,
                    help="per-request ceiling in seconds")
    ap.add_argument("--compile-cache", default=None,
                    help="accepted for the JAX CLI's command lines and ignored: the port "
                         "compiles no programs to cache")
    add_device_flag(ap)
    return ap


def _serving_mesh(args, device):
    """``--shard`` / ``--tp``: a mesh over every rank of the world, or None."""
    tp = args.tp or 1
    if not (args.shard or tp > 1):
        return None
    import torch.distributed as dist

    from consolver_torch.dist import mesh as meshlib

    meshlib.init_distributed(device)
    world = dist.get_world_size()
    if world % tp:
        raise SystemExit(f"--tp {tp} must divide the world size {world}")
    if not args.shard and world != tp:
        raise SystemExit(f"--tp {tp} without --shard needs a world of {tp} ranks, not {world}")
    return meshlib.init_mesh(world // tp if args.shard else 1, tp, device=device)


def _replica_count(args, device) -> int:
    """``--replicas N``: N single-card engines (0 = off)."""
    n = args.replicas or 0
    if n <= 1:
        return 0
    if args.shard or (args.tp or 1) > 1:
        raise SystemExit("--replicas is mutually exclusive with --shard/--tp "
                         "(pick one multi-card mode)")
    visible = torch.cuda.device_count() if device.type == "cuda" else n
    if n > visible:
        raise SystemExit(f"--replicas {n} > {visible} visible devices")
    return n


def _replica_devices(device, n):
    return [f"cuda:{i}" for i in range(n)] if device.type == "cuda" else [str(device)] * n


def _data_shards(mesh) -> int:
    from consolver_torch.dist.mesh import data_axis_size

    return data_axis_size(mesh)


def _batch_kwargs(args, shards: int = 1) -> dict:
    """``--batch-sizes`` / ``--adaptive-flush`` -> engine kwargs (sizes per
    data rank, like ``--batch-size``)."""
    out = {"adaptive_flush": bool(args.adaptive_flush)}
    if args.batch_sizes:
        out["batch_sizes"] = tuple(int(s) * shards for s in str(args.batch_sizes).split(","))
    return out


def _policy(cfg, args, device):
    from consolver_torch.cli.train_sd15 import make_policy
    from consolver_torch.policy.factor_net import FactorNet
    from consolver_torch.policy.io import load_factor_ckpt

    if not args.factor_ckpt:
        return make_policy(cfg.factor_net, 0, device)
    fcfg, state = load_factor_ckpt(args.factor_ckpt, cfg.factor_net)
    fnet = FactorNet(fcfg, device=device)
    fnet.load_state_dict(state)
    return fnet


def build_t2i_engine(args, device, mesh):
    from consolver_torch.cli.train_sd15 import build_pipeline
    from consolver_torch.serve import InferenceEngine, make_replicas

    if args.quantize and args.quantize_bits != 8:
        raise SystemExit("--quantize-bits 4 is an edit-family option (the SD UNet is "
                         "conv-dominated; int4 packing covers the FLUX DiT projections)")
    cfg = ExperimentConfig.sd15_ppo()
    if args.pretrained:
        cfg = apply_overrides(cfg, {"model.pretrained_path": args.pretrained})
    pipe = build_pipeline(cfg, _policy(cfg, args, device), device)
    if args.quantize and not pipe.unet.cfg.quant_int8:
        print("serving the int8 W8A8 path (.quantize())", flush=True)
        pipe = pipe.quantize()
    latent = args.latent_size or (64 if args.pretrained else 8)
    common = dict(latent_size=latent, flush_ms=args.flush_ms, max_wait_s=args.max_wait_s,
                  padded_max_steps=args.padded_max_steps)
    replicas = _replica_count(args, device)
    per = args.batch_size if args.batch_size is not None else 8
    if replicas:
        return make_replicas(pipe, InferenceEngine, replicas, _replica_devices(device, replicas),
                             batch_size=per, **common, **_batch_kwargs(args)), (
            f"generate replicas={replicas} batch={per}/replica latent={latent}")
    shards = _data_shards(mesh)
    return InferenceEngine(pipe, batch_size=per * shards, mesh=mesh, **common,
                           **_batch_kwargs(args, shards)), (
        f"generate batch={per * shards} latent={latent}"
        + (f" mesh={mesh.shape}" if mesh is not None else ""))


def build_edit_engine(args, device, mesh):
    from consolver_torch.cli.train_flux import build_pipeline
    from consolver_torch.data.tokenizer import load_tokenizer
    from consolver_torch.serve import EditInferenceEngine, make_replicas

    cfg = ExperimentConfig.flux_ppo()
    if args.pretrained:
        cfg = apply_overrides(cfg, {"model.pretrained_path": args.pretrained})
    pipe = build_pipeline(cfg, _policy(cfg, args, device), device)
    tcfg = pipe.transformer.cfg
    if args.quantize and not (tcfg.quant_int8 or tcfg.quant_int4):
        print(f"serving the int{args.quantize_bits} path (.quantize())", flush=True)
        pipe = pipe.quantize(bits=args.quantize_bits)
    # real tokenizers ride inside converted checkpoints
    t5_tok = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer_t5") if args.pretrained else None,
        kind="t5", max_length=args.t5_max_length)
    clip_tok = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer") if args.pretrained else None,
        kind="clip", max_length=77)
    resolution = args.resolution or (1024 if args.pretrained else 16)
    common = dict(resolution=resolution, t5_tokenizer=t5_tok, clip_tokenizer=clip_tok,
                  t5_max_length=args.t5_max_length,
                  clip_max_length=77 if args.pretrained else 4, flush_ms=args.flush_ms,
                  max_wait_s=args.max_wait_s, padded_max_steps=args.padded_max_steps)
    replicas = _replica_count(args, device)
    per = args.batch_size if args.batch_size is not None else 1
    if replicas:
        return make_replicas(pipe, EditInferenceEngine, replicas,
                             _replica_devices(device, replicas), batch_size=per, **common,
                             **_batch_kwargs(args)), (
            f"edit replicas={replicas} batch={per}/replica resolution={resolution}")
    shards = _data_shards(mesh)
    return EditInferenceEngine(pipe, batch_size=per * shards, mesh=mesh, **common,
                               **_batch_kwargs(args, shards)), (
        f"edit batch={per * shards} resolution={resolution}"
        + (f" mesh={mesh.shape}" if mesh is not None else ""))


def _prewarm(args, t2i_engine, edit_engine) -> None:
    """Run each serving program once before the port is bound: the
    default signature of each engine (re-stepped to every ``--prewarm``
    count), and with ``--prewarm-refine`` the refine signatures."""
    from consolver_torch.serve import EditRequest, GenerationRequest, ReplicaGroup
    from consolver_torch.serve.http import EDIT_REFINE_DEFAULTS, REFINE_DEFAULTS

    reqs = []  # (engine, request, re-stepped by --prewarm STEPS)
    if t2i_engine is not None:
        reqs.append((t2i_engine, GenerationRequest(prompt="prewarm"), True))
        if args.prewarm_refine:
            reqs.append((t2i_engine, GenerationRequest(prompt="prewarm", **REFINE_DEFAULTS),
                         False))
    if edit_engine is not None:
        side = (edit_engine.engines[0] if isinstance(edit_engine, ReplicaGroup)
                else edit_engine).resolution
        gray = np.full((side, side, 3), 127, np.uint8)
        reqs.append((edit_engine, EditRequest(instruction="prewarm", image=gray), True))
        if args.prewarm_refine:
            reqs.append((edit_engine, EditRequest(instruction="prewarm", image=gray,
                                                  **EDIT_REFINE_DEFAULTS), False))
    t0 = time.monotonic()
    n = 0
    for engine, request, expandable in reqs:
        warm = [request]
        if args.prewarm and expandable:
            warm = [dataclasses.replace(request, num_inference_steps=s) for s in args.prewarm]
        n += engine.prewarm(*warm, timeout=args.request_timeout)
    print(f"prewarmed {n} program(s) in {time.monotonic() - t0:.1f}s", flush=True)


def build_server(args):
    """Engines and the HTTP server from parsed arguments (separate from
    :func:`main` so that tests drive the CLI's wiring in-process).  Returns
    ``(server, engines, descriptions)``; ``server`` is None on a mesh rank
    other than 0, whose engines follow rank 0's."""
    from consolver_torch.serve import make_server

    device = resolve_device(args.device)
    mesh = _serving_mesh(args, device)
    if mesh is not None:
        device = mesh.device
        if args.family == "both":
            raise SystemExit("--family both serves on one card or over --replicas: over a "
                             "mesh the two engines' followers would share one process group")
    t2i_engine = edit_engine = None
    descs = []
    if args.family in ("sd", "both"):
        t2i_engine, desc = build_t2i_engine(args, device, mesh)
        descs.append(desc)
    if args.family in ("edit", "both"):
        edit_args = args
        if args.family == "both":
            edit_args = argparse.Namespace(**{**vars(args), "pretrained": args.edit_pretrained})
        edit_engine, desc = build_edit_engine(edit_args, device, mesh)
        descs.append(desc)
    engines = [e for e in (t2i_engine, edit_engine) if e is not None]
    if mesh is not None and not mesh.is_primary:
        return None, engines, descs
    if args.prewarm is not None:
        _prewarm(args, t2i_engine, edit_engine)
    server = make_server(t2i_engine, host=args.host, port=args.port,
                         request_timeout=args.request_timeout, edit_engine=edit_engine)
    return server, engines, descs


def install_sigterm_handler():
    """Route SIGTERM (the orchestrator's stop: k8s, systemd, docker stop)
    through the same drain as Ctrl-C, so that in-flight requests complete
    through ``engine.shutdown()`` instead of being dropped mid-batch."""
    import signal

    def _term(_signum, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)


def main(argv=None):
    args = _parser().parse_args(argv)
    server, engines, descs = build_server(args)
    if server is None:  # a follower rank: run rank 0's batches until it shuts down
        for engine in engines:
            engine.join()
        return
    install_sigterm_handler()
    # handler threads are joined at server_close, so that every response of
    # the drain is written before the process exits
    server.daemon_threads = False
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  ({'; '.join(descs)})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        for engine in engines:
            engine.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
