"""The slice through the command line against the JAX package's CLIs.

* One tiny hub directory (the port's seeded tiny UNet, VAE and CLIP under
  the hub's key names) goes through the JAX ``convert_checkpoints.py`` ->
  ``generate.py --solver ddim`` and through ``python -m consolver_torch
  convert`` -> ``generate --solver ddim``, with the same initial noise (the
  JAX sweep is handed the port's per-batch draws).  Both run the preset's
  bf16 models on the CPU; their PNGs agree within 1 uint8 level.
* ``train-sd`` for 2 steps writes a checkpoint bit-equal to the port's
  ``PPOTrainer.fit`` driven directly with the same config and models.
"""

import itertools
import random

import jax
import numpy as np
import torch

from consolver_torch.__main__ import main
from consolver_torch.cli import train_sd15
from consolver_torch.cli.selftest_eval import synthesize_sources
from consolver_torch.configs.config import parse_cli
from consolver_torch.data.group import TeacherDataset
from consolver_torch.data.teacher_gen import generate_teacher_set
from consolver_torch.rewards.registry import make_reward_fn
from consolver_torch.rl.train import PPOTrainer
from consolver_torch.utils.png import read_png

PNG_LEVELS = 1
SWEEP = ["--solver", "ddim", "--steps", "3", "--latent-size", "8", "--max-prompts", "4",
         "--batch-size", "2", "--seed", "0"]


def _port_noise(seed, batch_idx, shape):
    """The port's sweep noise of one batch (``eval.gen_sweep``'s generator)."""
    gen = torch.Generator().manual_seed(random.Random(f"{seed}-sweep-{batch_idx}").getrandbits(63))
    return torch.randn(shape, generator=gen).numpy()


def test_convert_and_generate_match_the_jax_clis(tmp_path, monkeypatch):
    from scripts import convert_checkpoints, generate
    from scripts.selftest_eval import run_cli

    synthesize_sources(str(tmp_path / "src"))
    for kind in ("unet", "vae", "clip_text"):
        run_cli(convert_checkpoints, ["--kind", kind, "--src", str(tmp_path / "src" / kind),
                                      "--dst", str(tmp_path / "jax_ckpts" / kind),
                                      "--config", "tiny"])
        assert main(["convert", "--kind", kind, "--src", str(tmp_path / "src" / kind), "--dst",
                     str(tmp_path / "ckpts" / kind), "--config", "tiny", "--device", "cpu"]) == 0

    normal, batches = jax.random.normal, iter(range(100))

    def port_draws(key, shape, *args, **kwargs):
        if tuple(shape)[1:] == (8, 8, 4):
            return jax.numpy.asarray(_port_noise(0, next(batches), tuple(shape)))
        return normal(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "normal", port_draws)
    run_cli(generate, [*SWEEP, "--pretrained", str(tmp_path / "jax_ckpts"),
                       "--out", str(tmp_path / "jax_out")])
    monkeypatch.setattr(jax.random, "normal", normal)
    assert main(["generate", *SWEEP, "--pretrained", str(tmp_path / "ckpts"),
                 "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    for i in range(4):
        mine, theirs = (read_png(str(tmp_path / d / f"{i:06d}.png")).astype(np.int32)
                        for d in ("out", "jax_out"))
        assert np.abs(mine - theirs).max() <= PNG_LEVELS, i


def test_train_sd_checkpoint_equals_a_direct_fit(tmp_path):
    generate_teacher_set(
        lambda generator, noise, ids: noise * 0.5,
        np.tile(np.array([[1, 5, 7, 2]], np.int64), (4, 1)), str(tmp_path / "teacher"),
        noise_shape=(8, 8, 4), batch_size=4, uncond_ids=np.array([1, 2, 0, 0], np.int64),
        device="cpu")
    argv = ["--preset", "sd15_ppo", "--set", f"data.train_data_dir={tmp_path / 'teacher'}",
            "--set", "data.batch_size=4", "--set", "train.max_train_steps=2",
            "--set", "train.min_inference_steps=2", "--set", "train.max_inference_steps=4",
            "--set", "reward.reward_type=image_psnr"]
    assert main(["train-sd", *argv, "--set", f"train.output_dir={tmp_path / 'cli'}",
                 "--device", "cpu"]) == 0

    cfg = parse_cli([*argv, "--set", f"train.output_dir={tmp_path / 'direct'}"])
    pipe = train_sd15.build_pipeline(
        cfg, train_sd15.make_policy(cfg.factor_net, cfg.train.seed, "cpu"), "cpu")
    trainer = PPOTrainer(pipe, make_reward_fn("image_psnr"), cfg.train)
    data = TeacherDataset(cfg.data.train_data_dir)
    trainer.fit(batch for epoch in itertools.count() for batch in data.batches(4, seed=epoch))
    trainer.save_checkpoint()
    mine, direct = (torch.load(tmp_path / d / "checkpoint-2" / "state.pt", weights_only=True)
                    for d in ("cli", "direct"))
    _assert_bit_equal(mine, direct)
    assert mine["global_step"] == 2


def _assert_bit_equal(a, b, path="state"):
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path
