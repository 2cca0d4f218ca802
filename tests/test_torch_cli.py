"""``python -m consolver_torch <command>`` (consolver_torch/__main__.py and
consolver_torch/cli/) on the CPU, in smoke mode and from tiny converted
checkpoints.

The counterparts of ``tests/test_train_cli.py`` (data parallelism over 2
gloo processes and the quantized rollout for both families, the bits knob)
and of the generation / dispatch cases of ``tests/test_eval_and_config.py``
(SDE and eta sweeps, a converted policy's dims flowing into generation, the
unified dispatch, serve / generate-edit / evaluate edit-score reaching their
modules); the reward dispatch's ``depth`` trap in both packages; every
command raising without a card; the teacher-set check that replaces the JAX CLI's endless wait; the
selftest chain.  Every command gets ``--device cpu``.  Nothing here is
numeric: exit codes, files written, dims, equality of configs.
"""

import json

import numpy as np
import pytest
import torch

from consolver_torch.__main__ import _COMMANDS, main
from consolver_torch.cli import convert_checkpoints, train_flux, train_sd15
from consolver_torch.configs.config import ExperimentConfig, apply_overrides
from consolver_torch.data.teacher_gen import generate_teacher_set
from consolver_torch.dist import launch
from consolver_torch.eval.gen_sweep import save_png
from consolver_torch.models.checkpoint import save_file
from consolver_torch.policy.factor_net import FactorNetConfig
from consolver_torch.policy.io import load_factor_ckpt
from tests import torch_dist_workers as workers

CPU = ["--device", "cpu"]
RUNNABLE = {
    "train-sd": [],
    "train-flux": ["--preset", "flux_ppo"],
    "generate": ["--out", "x"],
    "generate-teacher": ["--out", "x"],
    "evaluate": ["consistency", "--generated", "a", "--reference", "b"],
    "convert": ["--kind", "unet", "--src", "a", "--dst", "b"],
    "quantize": ["--family", "sd", "--pretrained", "a", "--dst", "b"],
    "preview": ["--out", "x"],
    "selftest": [],
    "serve": ["--port", "0"],
    "generate-edit": ["--source", "a", "--out", "x"],
}


def _sd_teacher(path, n):
    return generate_teacher_set(
        lambda generator, noise, ids: noise * 0.5,
        np.tile(np.array([[1, 5, 7, 2]], np.int64), (n, 1)), str(path),
        noise_shape=(8, 8, 4), batch_size=4, uncond_ids=np.array([1, 2, 0, 0], np.int64),
        device="cpu")


def _flux_teacher(path, n):
    rng = np.random.default_rng(0)
    path.mkdir()
    for i in range(n):
        np.savez(path / f"{i:06d}.npz",
                 noise=rng.standard_normal((8, 8, 4)).astype(np.float32),
                 latent=rng.standard_normal((8, 8, 4)).astype(np.float32),
                 ref_image=np.zeros((16, 16, 3), np.float32),
                 t5_ids=np.ones((4,), np.int64), clip_ids=np.ones((4,), np.int64))


def _train_argv(family, teacher, out, *extra):
    preset = "sd15_ppo" if family == "sd" else "flux_ppo"
    return [f"train-{family}", "--preset", preset, *CPU,
            "--set", f"data.train_data_dir={teacher}", "--set", "data.batch_size=2",
            "--set", "train.min_inference_steps=2", "--set", "train.max_inference_steps=3",
            "--set", f"train.output_dir={out}", "--set", "train.checkpointing_steps=1", *extra]


def _checkpoints(out):
    return sorted(d.name for d in out.iterdir() if d.name.startswith("checkpoint-"))


# ---------------------------------------------------------------- dispatch


def test_unified_cli_dispatch(tmp_path, capsys):
    assert main([]) == 0
    usage = capsys.readouterr().out
    assert "python -m consolver_torch" in usage and all(name in usage for name in _COMMANDS)
    assert main(["no-such-command"]) == 2
    import importlib

    for name, module in _COMMANDS.items():
        assert callable(importlib.import_module(f"consolver_torch.cli.{module}").main), name
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    for d in (gen, ref):
        d.mkdir()
        for i in range(2):
            save_png(str(d / f"{i}.png"), np.full((8, 8, 3), 0.15 * (i + 1), np.float32))
    out = tmp_path / "stats.json"
    assert main(["evaluate", "consistency", "--generated", str(gen), "--reference", str(ref),
                 "--reward", "image_psnr", "--out", str(out), *CPU]) == 0
    stats = json.loads(out.read_text())
    assert stats["num_scored"] == 2 and stats["num_errors"] == 0


@pytest.mark.parametrize("argv, module", [
    (["serve", "--port", "0"], "serve"),
    (["generate-edit", "--source", "s", "--out", "o"], "generate_edit"),
    (["evaluate", "edit-score", "--results", "r", "--judge-ckpt", "j"], "evaluate")])
def test_once_left_out_commands_dispatch_to_their_modules(monkeypatch, argv, module):
    """serve, generate-edit and evaluate edit-score reach their modules'
    ``main`` with the rest of the command line (they exited 2 before their
    ports)."""
    import importlib

    seen = []
    mod = importlib.import_module(f"consolver_torch.cli.{module}")
    monkeypatch.setattr(mod, "main", lambda rest: seen.append(rest))
    assert main(argv) == 0
    assert seen == [argv[1:]]


@pytest.mark.parametrize("command", sorted(RUNNABLE))
def test_commands_raise_without_a_card(monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, *RUNNABLE[command]])


# ---------------------------------------------------------- training commands


def test_data_parallel_commands(tmp_path):
    """Over two gloo processes: both trainers with dist.data_parallel=2 (the
    global batch is the per-shard batch x 2, one prompt group per shard;
    rank 0 checkpoints), and ``generate --shard`` / ``evaluate consistency
    --shard`` (each rank runs its rows, rank 0 writes), against the
    one-process sweep within 1 uint8 level and the same statistics."""
    from consolver_torch.utils.png import read_png

    _sd_teacher(tmp_path / "sd_teacher", 8)
    _flux_teacher(tmp_path / "flux_teacher", 4)
    sweep = ["generate", "--solver", "consistencysolver", "--steps", "3", "--max-prompts", "6",
             "--batch-size", "4", *CPU]
    commands = [
        _train_argv("sd", tmp_path / "sd_teacher", tmp_path / "sd_run",
                    "--set", "dist.data_parallel=2", "--set", "train.max_train_steps=2"),
        _train_argv("flux", tmp_path / "flux_teacher", tmp_path / "flux_run",
                    "--set", "dist.data_parallel=2", "--set", "train.max_train_steps=1"),
        [*sweep, "--shard", "--out", str(tmp_path / "sharded")],
        ["evaluate", "consistency", "--generated", str(tmp_path / "sharded"), "--reference",
         str(tmp_path / "sharded"), "--shard", "--out", str(tmp_path / "stats.json"), *CPU],
    ]
    codes = launch.spawn(workers.cli_dp_rank, 2, timeout_s=240, args=(commands,))
    assert codes == [[0, 0, 0, 0], [0, 0, 0, 0]]
    assert _checkpoints(tmp_path / "sd_run") == ["checkpoint-1", "checkpoint-2"]
    assert _checkpoints(tmp_path / "flux_run") == ["checkpoint-1"]
    assert main([*sweep, "--out", str(tmp_path / "one")]) == 0
    for i in range(6):
        sharded, one = (read_png(str(tmp_path / d / f"{i:06d}.png")).astype(np.int32)
                        for d in ("sharded", "one"))
        assert np.abs(sharded - one).max() <= 1, i
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["num_scored"] == 6 and stats["num_errors"] == 0


@pytest.mark.parametrize("family", ["sd", "flux"])
def test_train_cli_quantized_rollout(tmp_path, family):
    if family == "sd":
        _sd_teacher(tmp_path / "teacher", 4)
    else:
        _flux_teacher(tmp_path / "teacher", 2)
    extra = ["--set", "model.quantize_rollout=true", "--set", "train.max_train_steps=1"]
    if family == "flux":
        extra += ["--set", "dist.data_parallel=1"]
    assert main(_train_argv(family, tmp_path / "teacher", tmp_path / "run", *extra)) == 0
    assert (tmp_path / "run" / "checkpoint-1").is_dir()


def test_flux_quantize_bits_knob():
    cfg = apply_overrides(ExperimentConfig.flux_ppo(), {"model.quantize_rollout": "true",
                                                        "data.batch_size": "2"})
    pipe = train_flux.build_pipeline(cfg, train_sd15.make_policy(cfg.factor_net, 0, "cpu"),
                                     "cpu")
    q8 = train_flux.maybe_quantize_rollout(pipe, cfg)
    assert q8.transformer.cfg.quant_int8 and not q8.transformer.cfg.quant_int4
    cfg4 = apply_overrides(cfg, {"model.quantize_bits": "4"})
    q4 = train_flux.maybe_quantize_rollout(pipe, cfg4)
    assert q4.transformer.cfg.quant_int4 and q4.transformer.cfg.quant_mode == "int4"
    assert train_flux.maybe_quantize_rollout(q8, cfg4) is q8  # already quantized
    off = apply_overrides(cfg, {"model.quantize_rollout": "false"})
    assert train_flux.maybe_quantize_rollout(pipe, off) is pipe


def test_teacher_set_smaller_than_a_batch_raises(tmp_path):
    """The JAX CLI loops forever here (its dataset yields no batch)."""
    _sd_teacher(tmp_path / "teacher", 4)
    with pytest.raises(ValueError, match="holds 4 samples.*global batch of 8"):
        main(_train_argv("sd", tmp_path / "teacher", tmp_path / "run",
                         "--set", "data.batch_size=8"))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_depth_reward_trap_of_the_jax_cli(capsys, package):
    """No depth model is built: ``depth`` with an encoder checkpoint reaches
    ``make_reward_fn("depth", RewardModel())`` and raises; without one it
    falls back to image_psnr."""
    if package == "jax":
        from consolver_tpu.configs.config import ExperimentConfig as JaxConfig
        from consolver_tpu.configs.config import apply_overrides as jax_overrides
        from scripts.train_sd15 import build_reward

        cfg = JaxConfig.sd15_ppo()
        with_ckpt = jax_overrides(cfg, {"reward.encoder_checkpoint": "some/dir"})

        def reward(c):
            return build_reward(c)
    else:
        cfg = ExperimentConfig.sd15_ppo()
        with_ckpt = apply_overrides(cfg, {"reward.encoder_checkpoint": "some/dir"})

        def reward(c):
            return train_sd15.build_reward(c, "cpu")
    assert cfg.reward.reward_type == "depth"
    with pytest.raises(ValueError, match="needs RewardModel.depth"):
        reward(with_ckpt)
    fallback = reward(cfg)
    assert "[smoke mode] reward 'depth'" in capsys.readouterr().out
    x = np.full((1, 4, 4, 3), 0.5, np.float32)
    value = fallback(*(torch.from_numpy(x),) * 2) if package == "port" else fallback(x, x)
    assert np.isfinite(np.asarray(value)).all()


# -------------------------------------------------------- generation commands


def test_generate_cli_sde_and_eta_sweeps(tmp_path):
    assert main(["generate", "--solver", "sde-dpmsolver++", "--steps", "3", *CPU,
                 "--out", str(tmp_path / "sde"), "--max-prompts", "2", "--batch-size", "2"]) == 0
    assert len(list((tmp_path / "sde").glob("*.png"))) == 2
    assert main(["generate", "--solver", "ddim", "--eta", "0.7", "--steps", "3", *CPU,
                 "--out", str(tmp_path / "eta"), "--max-prompts", "4", "--batch-size", "2"]) == 0
    assert len(list((tmp_path / "eta").glob("*.png"))) == 4


def test_factor_ckpt_dims_flow_to_generation(tmp_path):
    """convert --kind factor_net records the dims beside the component and
    generate rebuilds the net at THOSE dims (gen.sh: 21 actions where
    run_ppo.sh trains 11); wrong dims fail at convert time."""
    cfg = FactorNetConfig(num_actions=21, order_dim=4, scaler_dim=0, family="sd")
    torch.manual_seed(0)
    mlp = torch.nn.Sequential(
        torch.nn.Linear(2, cfg.hidden_dim), torch.nn.ReLU(),
        torch.nn.Linear(cfg.hidden_dim, cfg.hidden_dim), torch.nn.ReLU(),
        torch.nn.Linear(cfg.hidden_dim, cfg.num_actions * cfg.action_dims))
    (tmp_path / "src").mkdir()
    save_file({f"mlp.{k}": v for k, v in mlp.state_dict().items()},
              str(tmp_path / "src" / "model.safetensors"))
    dst = tmp_path / "ckpt" / "factor_net"
    assert main(["convert", "--kind", "factor_net", "--src", str(tmp_path / "src"),
                 "--dst", str(dst), "--num-actions", "21", *CPU]) == 0
    assert (tmp_path / "ckpt" / "factor_net_factor_net_config.json").exists()
    loaded_cfg, state = load_factor_ckpt(str(dst), FactorNetConfig())
    assert loaded_cfg.num_actions == 21 and loaded_cfg.order_dim == 4
    assert torch.equal(state["head.weight"], mlp[4].weight)
    with pytest.raises(SystemExit, match="dims mismatch"):
        convert_checkpoints.main(["--kind", "factor_net", "--src", str(tmp_path / "src"),
                                  "--dst", str(tmp_path / "bad"), "--num-actions", "11", *CPU])
    assert main(["generate", "--solver", "consistencysolver", "--steps", "3", *CPU,
                 "--factor-ckpt", str(dst), "--out", str(tmp_path / "out"),
                 "--max-prompts", "2", "--batch-size", "2"]) == 0
    assert len(list((tmp_path / "out").glob("*.png"))) == 2


def test_teacher_quantize_and_preview_commands(tmp_path):
    """generate-teacher (both families), quantize (SD int8, FLUX int4) into a
    drop-in --pretrained directory that generate and train read, preview."""
    from consolver_torch.cli.selftest_eval import synthesize_sources
    from consolver_torch.data.edit_prep import prepare_edit_set
    from consolver_torch.models.checkpoint import load_model_config
    from consolver_torch.models.unet_2d import UNetConfig
    from consolver_torch.utils.png import write_png

    synthesize_sources(str(tmp_path / "src"))
    for kind in ("unet", "vae", "clip_text"):
        assert main(["convert", "--kind", kind, "--src", str(tmp_path / "src" / kind),
                     "--dst", str(tmp_path / "ckpts" / kind), "--config", "tiny", *CPU]) == 0
    assert main(["quantize", "--family", "sd", "--pretrained", str(tmp_path / "ckpts"),
                 "--dst", str(tmp_path / "int8"), *CPU]) == 0
    qcfg = load_model_config(str(tmp_path / "int8" / "unet"), UNetConfig, None)
    assert qcfg.quant_int8 and qcfg.quant_skip_levels == (0,)
    assert main(["generate", "--pretrained", str(tmp_path / "int8"), "--latent-size", "8",
                 "--steps", "2", "--max-prompts", "2", "--batch-size", "2", *CPU,
                 "--out", str(tmp_path / "int8_out")]) == 0
    assert main(["generate-teacher", "--solver", "ddim", "--steps", "2", "--max-prompts", "4",
                 "--batch-size", "4", "--out", str(tmp_path / "teacher"), *CPU]) == 0
    assert len(list((tmp_path / "teacher").glob("*.npz"))) == 4
    assert main(["preview", "--candidates", "2", "--preview-steps", "2", "--refine-steps", "3",
                 "--accept", "1", "--out", str(tmp_path / "preview"), *CPU]) == 0
    assert sorted(p.name for p in (tmp_path / "preview").iterdir()) == [
        "preview_0.png", "preview_1.png", "refined_1.png"]

    rng = np.random.default_rng(1)
    (tmp_path / "edit_src").mkdir()
    for i in range(2):
        write_png(str(tmp_path / "edit_src" / f"im{i}.png"),
                  rng.integers(0, 255, (24, 24, 3), dtype=np.uint8))
        (tmp_path / "edit_src" / f"im{i}.txt").write_text(f"make it bluer {i}")
    assert prepare_edit_set(str(tmp_path / "edit_src"), str(tmp_path / "edit_prep"),
                            resolution=16) == 2
    assert main(["generate-teacher", "--family", "flux", "--source", str(tmp_path / "edit_prep"),
                 "--out", str(tmp_path / "flux_teacher"), "--steps", "2", "--batch-size", "2",
                 *CPU]) == 0
    assert len(list((tmp_path / "flux_teacher").glob("*.npz"))) == 2

    # a tiny FLUX stack (smoke mode's configs) converted, then quantized to int4
    import dataclasses

    from consolver_torch.models.checkpoint import hub_state_dict
    from consolver_torch.models.flux import FluxConfig

    smoke = train_flux.build_pipeline(ExperimentConfig.flux_ppo(), None, "cpu")
    for name, kind, module in (("transformer", "flux", smoke.transformer),
                               ("t5", "t5", smoke.t5), ("clip_text", "clip_text", smoke.clip),
                               ("vae", "vae", smoke.vae)):
        (tmp_path / "fsrc" / name).mkdir(parents=True)
        save_file(hub_state_dict(module, kind), str(tmp_path / "fsrc" / name / "m.safetensors"))
        (tmp_path / f"{name}.json").write_text(json.dumps(dataclasses.asdict(module.cfg)))
        assert main(["convert", "--kind", kind, "--src", str(tmp_path / "fsrc" / name),
                     "--dst", str(tmp_path / "flux" / name), "--config",
                     str(tmp_path / f"{name}.json"), *CPU]) == 0
    assert main(["quantize", "--family", "flux", "--bits", "4", "--pretrained",
                 str(tmp_path / "flux"), "--dst", str(tmp_path / "flux_int4"), *CPU]) == 0
    cfg = apply_overrides(ExperimentConfig.flux_ppo(),
                          {"model.pretrained_path": str(tmp_path / "flux_int4")})
    loaded = train_flux.build_pipeline(cfg, None, "cpu")
    assert loaded.transformer.cfg == dataclasses.replace(smoke.transformer.cfg, quant_int4=True)
    assert isinstance(FluxConfig(), type(loaded.transformer.cfg))


def test_selftest_chain(tmp_path):
    assert main(["selftest", "--workdir", str(tmp_path), *CPU]) == 0
    stats = json.loads((tmp_path / "out" / "stats.json").read_text())
    assert stats["num_scored"] == 8 and stats["num_errors"] == 0
