"""consolver_torch's EditPPOTrainer against the JAX package's on the tiny
FLUX stack of ``tests/test_edit.py::make_tiny_flux_pipeline``, and the
teacher-set generators against the JAX ones.

One ``train_step`` on each side with the same batch, the JAX policy's
actions injected into the port's rollout as in ``tests/test_torch_train.py``
(the FM solver with ``order_dim=2`` also passes its single history slot
through at step 0, so step 0's action cannot move the latents).  Held: the
step count and group picks (exact), the trajectory's conds, actions and
masks (exact), old probabilities (2e-4), the policy and Euler-baseline
rewards (PSNR, 2e-3 dB), the baseline-clipped advantages (no scale; 2e-2:
they divide by the group's reward spread) and the loss metrics (2e-3).
The teacher generators get the JAX noise injected through
``teacher_gen.example_noise`` and must write the same files, keys and
latents.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.data import teacher_gen as tteacher
from consolver_torch.models.clip_text import ClipTextConfig as TClipConfig
from consolver_torch.models.clip_text import ClipTextEncoder as TClip
from consolver_torch.models.convert import load_jax_params
from consolver_torch.models.flux import FluxConfig as TFluxConfig
from consolver_torch.models.flux import FluxTransformer as TFlux
from consolver_torch.models.t5 import T5Config as TT5Config
from consolver_torch.models.t5 import T5Encoder as TT5
from consolver_torch.models.vae import AutoencoderKL as TVae
from consolver_torch.models.vae import VaeConfig as TVaeConfig
from consolver_torch.pipelines.edit import FluxKontextPipeline as TPipe
from consolver_torch.policy.factor_net import FactorNet as TFactorNet
from consolver_torch.policy.factor_net import FactorNetConfig as TFConfig
from consolver_torch.rewards import metrics as tmetrics
from consolver_torch.rl import ppo as tppo
from consolver_torch.rl import train as ttrain
from consolver_torch.rl import train_edit as ttrain_edit
from consolver_torch.utils import png
from consolver_tpu.data import teacher_gen as jteacher
from consolver_tpu.pipelines.edit import FluxKontextPipeline as JPipe
from consolver_tpu.policy.factor_net import FactorNet, FactorNetConfig
from consolver_tpu.rewards import metrics as jmetrics
from consolver_tpu.rl import ppo as jppo
from consolver_tpu.rl import train as jtrain
from consolver_tpu.rl import train_edit as jtrain_edit
from tests.test_edit import make_tiny_flux_pipeline
from tests.test_torch_train import _capture, assert_params_close, inject_actions
from tests.torch_dist_workers import world1_mesh

# temperature 1, not the FM family's 0.01, so that the rows sample different
# actions and the group's rewards spread
FNET = dict(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11, family="fm",
            temperature_override=1.0)
PROB_TOL = dict(rtol=2e-4, atol=2e-4)
REWARD_TOL = dict(rtol=0, atol=2e-3)
LOSS_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def base():
    return make_tiny_flux_pipeline()


def _pipelines(base, seed=0):
    """Both pipelines with the tiny stack's weights and a fresh std-0.3
    policy."""
    rng = np.random.default_rng(seed)
    fparams = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
                           base.factor_params)
    jpipe = JPipe(base.transformer, base.transformer_params, base.t5, base.t5_params, base.clip,
                  base.clip_params, base.vae, base.vae_params,
                  factor_net=FactorNet(FactorNetConfig(**FNET)), factor_params=fparams)
    tpipe = TPipe(
        load_jax_params(TFlux(TFluxConfig.tiny(), device="cpu"), base.transformer_params),
        load_jax_params(TT5(TT5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                                      num_heads=4), device="cpu"), base.t5_params),
        load_jax_params(TClip(TClipConfig(vocab_size=64, hidden_size=24, num_layers=1, num_heads=2,
                                          intermediate_size=32), device="cpu"), base.clip_params),
        load_jax_params(TVae(TVaeConfig(block_out_channels=(8, 16), layers_per_block=1,
                                        norm_num_groups=4, latent_channels=4), device="cpu"),
                        base.vae_params),
        factor_net=load_jax_params(TFactorNet(TFConfig(**FNET), device="cpu"), fparams),
        device="cpu",
    )
    return jpipe, tpipe


def _batch(seed=0, rows=6):
    rng = np.random.default_rng(seed)
    return {
        "noise": rng.standard_normal((rows, 8, 8, 4)).astype(np.float32),
        "latent": rng.standard_normal((rows, 8, 8, 4)).astype(np.float32),
        "ref_image": rng.uniform(-1, 1, (rows, 16, 16, 3)).astype(np.float32),
        "t5_ids": rng.integers(1, 64, (rows, 4)).astype(np.int64),
        "clip_ids": rng.integers(1, 64, (rows, 4)).astype(np.int64),
    }


def _configs(**kwargs):
    ppo_kwargs = dict(ppo_epochs=1, learning_rate=1e-3, advantage_scale=1.0)
    fields = dict(guidance_scale=2.5, min_inference_steps=2, max_inference_steps=4, seed=0,
                  output_dir="unused")
    fields.update(kwargs)
    return (jtrain.TrainConfig(**fields, ppo=jppo.PPOConfig(**ppo_kwargs)),
            ttrain.TrainConfig(**fields, ppo=tppo.PPOConfig(**ppo_kwargs)))


def _recorded(metric, captured, to_numpy):
    def reward(pred, target):
        r = metric(pred, target)
        captured.setdefault("rewards", []).append(to_numpy(r))
        return r

    return reward


@pytest.mark.parametrize("padded", [False, True], ids=["per_count", "padded"])
def test_edit_train_step_matches_jax(base, monkeypatch, padded):
    jpipe, tpipe = _pipelines(base)
    jcfg, tcfg = _configs(padded_rollout=padded, max_inference_steps=5 if padded else 4)
    jcap, tcap = {}, {}
    _capture(monkeypatch, jppo, jtrain_edit, jcap)
    _capture(monkeypatch, tppo, ttrain_edit, tcap)
    jtrainer = jtrain_edit.EditPPOTrainer(
        jpipe, _recorded(jmetrics.image_psnr_reward, jcap, np.asarray), jcfg)
    ttrainer = ttrain_edit.EditPPOTrainer(
        tpipe, _recorded(tmetrics.image_psnr_reward, tcap, lambda r: r.numpy().copy()), tcfg)

    j_metrics = jtrainer.train_step(_batch())
    steps = inject_actions(monkeypatch, ttrainer.factor_net, jcap["traj"].actions)
    t_metrics = ttrainer.train_step(_batch())
    assert steps["i"] == jcap["traj"].actions.shape[1] + 1
    assert t_metrics["num_inference"] == j_metrics["num_inference"] == 3
    for k, v in jcap["batch"].items():
        np.testing.assert_array_equal(tcap["batch"][k], v)
    for name in ("conds_x", "actions", "masks"):
        np.testing.assert_array_equal(getattr(tcap["traj"], name).numpy(),
                                      np.asarray(getattr(jcap["traj"], name)), err_msg=name)
    if padded:  # 3 real steps of a 4-step program: the last row is a pad
        np.testing.assert_array_equal(tcap["traj"].valid[0].numpy(), [1, 1, 0])
    np.testing.assert_allclose(tcap["old_probs"], jcap["old_probs"], **PROB_TOL)
    for got, want in zip(tcap["rewards"], jcap["rewards"], strict=True):  # policy, then baseline
        np.testing.assert_allclose(got, want, **REWARD_TOL)
    assert np.ptp(jcap["rewards"][0]) > 1e-3  # the rows' actions differ
    np.testing.assert_allclose(tcap["advantages"], jcap["advantages"], rtol=0, atol=2e-2)
    for name in ("loss", "policy_loss", "entropy", "ratio_mean", "grad_norm", "reward",
                 "baseline_reward"):
        np.testing.assert_allclose(t_metrics[name], j_metrics[name], err_msg=name, **LOSS_TOL)
    assert_params_close(ttrainer.factor_net, jtrainer.params, tcfg.ppo.learning_rate)


def test_edit_trainer_unported_options_raise(base, tmp_path):
    """``dump_samples_to`` writes the step's first policy images as PNGs named
    by their advantage; data parallelism (ROADMAP A.15) is ported, so a mesh
    is accepted (a one-rank mesh here, ``tests/test_torch_tp.py`` for more)."""
    _, tpipe = _pipelines(base)
    _, cfg = _configs()
    trainer = ttrain_edit.EditPPOTrainer(tpipe, tmetrics.image_psnr_reward, cfg,
                                         dump_samples_to=str(tmp_path))
    trainer.train_step(_batch(rows=2))
    names = sorted(os.listdir(tmp_path / "step_0"))
    assert len(names) == 2 and all(n.startswith("sample_") and "_adv_" in n for n in names)
    img = png.read_png(str(tmp_path / "step_0" / names[0]))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    with world1_mesh() as mesh:
        meshed = ttrain_edit.EditPPOTrainer(tpipe, tmetrics.image_psnr_reward, cfg, mesh=mesh)
        assert meshed.num_groups == 1 and meshed.grad_sync is not None


def _toy_denoise(noise, ids):
    """A deterministic teacher: example 1 of each batch turns NaN."""
    out = noise * 0.5 + ids.sum(-1).reshape(-1, 1, 1, 1) * 0.01
    nan_row = (np.arange(noise.shape[0]) == 1).reshape(-1, 1, 1, 1)
    return out, nan_row


def _assert_same_files(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        with np.load(os.path.join(want_dir, name)) as w, np.load(os.path.join(got_dir, name)) as g:
            assert sorted(g.files) == sorted(w.files), name
            for key in w.files:
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name} {key}")
    return names


def test_generate_teacher_set_matches_jax(tmp_path, monkeypatch):
    ids = np.random.default_rng(1).integers(1, 99, (5, 6)).astype(np.int32)
    uncond = np.array([1, 2, 0, 0, 0, 0])
    shape, seed, batch = (4, 4, 2), 3, 2

    def j_denoise(key, noise, prompt_ids):
        out, nan_row = _toy_denoise(noise, prompt_ids)
        return jnp.where(nan_row, jnp.nan, out)

    def t_denoise(generator, noise, prompt_ids):
        assert isinstance(generator, torch.Generator)
        out, nan_row = _toy_denoise(noise, prompt_ids)
        return torch.where(torch.from_numpy(nan_row), torch.nan, out)

    j_n = jteacher.generate_teacher_set(j_denoise, ids, str(tmp_path / "jax"), shape,
                                        batch_size=batch, seed=seed, uncond_ids=uncond)
    noise = {}  # the JAX noise per example: one draw per batch
    for start in range(0, len(ids), batch):
        knoise, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), start))
        rows = np.asarray(jax.random.normal(knoise, (min(batch, len(ids) - start), *shape)))
        noise.update({start + j: row for j, row in enumerate(rows)})
    monkeypatch.setattr(tteacher, "example_noise", lambda s, i, sh: torch.from_numpy(noise[i]))
    t_n = tteacher.generate_teacher_set(t_denoise, ids, str(tmp_path / "torch"), shape,
                                        batch_size=batch, seed=seed, uncond_ids=uncond,
                                        device="cpu")
    assert t_n == j_n == 3  # examples 1 and 3 were NaN
    names = _assert_same_files(tmp_path / "torch", tmp_path / "jax")
    assert names == ["000000.npz", "000002.npz", "000004.npz"]
    with pytest.raises(ValueError, match="uncond_ids"):
        tteacher.generate_teacher_set(t_denoise, ids, str(tmp_path / "x"), shape,
                                      uncond_ids=np.zeros(3), device="cpu")


def test_generate_edit_teacher_set_matches_jax(tmp_path, monkeypatch):
    prepared = tmp_path / "prepared"
    prepared.mkdir()
    rng = np.random.default_rng(2)
    for i, text in enumerate(["make it red", "add a hat", "remove the car"]):
        np.savez(prepared / f"{i:06d}.npz", ref_image=rng.uniform(-1, 1, (16, 16, 3)),
                 instruction=np.asarray(text))
    shape, seed = (4, 4, 4), 42

    def tokenize(texts):
        t5 = np.array([[len(t), ord(t[0]), 1] for t in texts], np.int32)
        return t5, t5[:, ::-1].copy()

    def toy(noise, t5, clip, ref):
        out = noise * 0.5 + (t5.sum(-1) - clip[:, 0]).reshape(-1, 1, 1, 1) * 0.01
        return out + ref.mean(axis=(1, 2, 3)).reshape(-1, 1, 1, 1)

    def j_denoise(key, noise, t5, clip, ref):
        out = toy(noise, t5, clip, ref)
        return jnp.where(t5[:, 0:1, None, None] == 9, jnp.nan, out)  # "add a hat" is NaN

    def t_denoise(generator, noise, t5, clip, ref):
        out = toy(noise, t5, clip, ref)
        return torch.where(t5[:, 0:1, None, None] == 9, torch.nan, out)

    j_n = jteacher.generate_edit_teacher_set(j_denoise, tokenize, str(prepared),
                                             str(tmp_path / "jax"), shape, seed=seed)
    noise = {i: np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(seed), i),
                                             (1, *shape)))[0] for i in range(3)}
    monkeypatch.setattr(tteacher, "example_noise", lambda s, i, sh: torch.from_numpy(noise[i]))
    t_n = tteacher.generate_edit_teacher_set(t_denoise, tokenize, str(prepared),
                                             str(tmp_path / "torch"), shape, seed=seed,
                                             device="cpu")
    assert t_n == j_n == 2
    assert _assert_same_files(tmp_path / "torch", tmp_path / "jax") == ["000000.npz", "000002.npz"]


def test_example_noise_is_per_example_and_device_free():
    a = tteacher.example_noise(5, 3, (2, 2))
    assert torch.equal(a, tteacher.example_noise(5, 3, (2, 2))) and a.dtype == torch.float32
    assert not torch.equal(a, tteacher.example_noise(5, 4, (2, 2)))
    assert not torch.equal(a, tteacher.example_noise(6, 3, (2, 2)))


def test_teacher_sanity_images_raise(tmp_path):
    """``decode_fn`` with ``save_sanity_images`` writes ``sanity_{i:03d}.png``
    for the first samples, through ``eval.gen_sweep.save_png``, as the JAX
    generators do."""
    def decode(latents):  # [B, 2, 2, 4] -> [B, 2, 2, 3] in [0, 1]
        return torch.sigmoid(latents[..., :3])

    ids = np.arange(12).reshape(4, 3) + 1
    n = tteacher.generate_teacher_set(lambda g, noise, i: noise, ids, str(tmp_path / "sd"),
                                      (2, 2, 4), batch_size=2, decode_fn=decode,
                                      save_sanity_images=3, device="cpu")
    assert n == 4
    sanity = sorted(f for f in os.listdir(tmp_path / "sd") if f.endswith(".png"))
    assert sanity == ["sanity_000.png", "sanity_001.png", "sanity_002.png"]
    with np.load(tmp_path / "sd" / "000001.npz") as z:
        want = np.clip(decode(torch.from_numpy(z["latent"]))[None].numpy() * 255.0 + 0.5,
                       0, 255).astype(np.uint8)[0]
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "sd" / "sanity_001.png")), want)

    prepared = tmp_path / "prepared"
    prepared.mkdir()
    for i in range(2):
        np.savez(prepared / f"{i:06d}.npz", ref_image=np.zeros((4, 4, 3), np.float32),
                 instruction=np.asarray(f"edit {i}"))
    n = tteacher.generate_edit_teacher_set(
        lambda g, noise, *a: noise, lambda t: (np.ones((len(t), 2)), np.ones((len(t), 2))),
        str(prepared), str(tmp_path / "edit"), (2, 2, 4), decode_fn=decode,
        save_sanity_images=1, device="cpu")
    assert n == 2
    assert sorted(f for f in os.listdir(tmp_path / "edit") if f.endswith(".png")) == [
        "sanity_000.png"]
