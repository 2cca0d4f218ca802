"""consolver_torch's eval stack (FID, the consistency harness, the DINO
PCA map), the VLM judges' host part, and the trainers on their production
rewards, against the JAX package's.

* ``fid``: the statistics and the distance are the JAX functions' numpy /
  scipy, so they must be equal; ``compute_fid`` with the same features too.
* ``vlm``: the parsers, prompts and retry / fallback must be equal.
* ``evaluate_consistency`` over a PNG directory must match the JAX harness
  within 1e-5 (the same PNG pixels; the rewards' own 1e-4 parity is
  ``tests/test_torch_backbones.py``'s); a JPEG is one error record.
* ``dino_vis`` within 1e-4 (an SVD of features that agree to 1e-5).
* One ``PPOTrainer.train_step`` on ``depth`` (tiny Depth-Anything) and one
  ``EditPPOTrainer.train_step`` on ``dino`` (tiny ViT) against the JAX
  trainers, with the JAX policy's actions injected into the port's rollout
  as in ``tests/test_torch_train.py``, held at that file's tolerances.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.eval import consistency as tcons
from consolver_torch.eval import dino_vis as tvis
from consolver_torch.eval import fid as tfid
from consolver_torch.eval.gen_sweep import save_png
from consolver_torch.models import depth_anything as tda
from consolver_torch.models import vit as tvit
from consolver_torch.models.convert import load_jax_params
from consolver_torch.rewards import metrics as tmetrics
from consolver_torch.rewards import registry as treg
from consolver_torch.rewards import vlm as tvlm
from consolver_torch.rl import ppo as tppo
from consolver_torch.rl import train as ttrain
from consolver_torch.rl import train_edit as ttrain_edit
from consolver_tpu.eval import consistency as jcons
from consolver_tpu.eval import dino_vis as jvis
from consolver_tpu.eval import fid as jfid
from consolver_tpu.models import depth_anything as jda
from consolver_tpu.models import vit as jvit
from consolver_tpu.rewards import metrics as jmetrics
from consolver_tpu.rewards import registry as jreg
from consolver_tpu.rewards import vlm as jvlm
from consolver_tpu.rl import ppo as jppo
from consolver_tpu.rl import train as jtrain
from consolver_tpu.rl import train_edit as jtrain_edit
from tests.torch_dist_workers import world1_mesh
from tests.test_torch_backbones import _perturb, _port_config
from tests.test_torch_pipeline import stacks  # noqa: F401  (fixture)
from tests.test_torch_train import _capture, assert_params_close, inject_actions
from tests.test_torch_train import _configs as sd_configs
from tests.test_torch_train import _pipelines as sd_pipelines
from tests.test_torch_train_edit import _batch as edit_batch
from tests.test_torch_train_edit import _configs as edit_configs
from tests.test_torch_train_edit import _pipelines as edit_pipelines
from tests.test_torch_train_edit import base  # noqa: F401  (fixture)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
PROB_TOL = dict(rtol=2e-4, atol=2e-4)
REWARD_TOL = dict(rtol=0, atol=2e-3)
LOSS_TOL = dict(rtol=2e-3, atol=2e-3)


def _dino_pair(seed=1):
    jmodel = jvit.ViT(jvit.ViTConfig.tiny())
    params = _perturb(jmodel.init(jax.random.key(0), jnp.zeros((1, 28, 28, 3))), seed)
    tmodel = tvit.ViT(_port_config(tvit.ViTConfig, jmodel.cfg), device="cpu")
    return jmodel, params, load_jax_params(tmodel, params)


def _depth_pair(seed=2):
    jmodel = jda.DepthAnything(jda.DepthAnythingConfig.tiny())
    params = _perturb(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 28, 28, 3))), seed)
    tmodel = tda.DepthAnything(_port_config(tda.DepthAnythingConfig, jmodel.cfg), device="cpu")
    return jmodel, params, load_jax_params(tmodel, params)


# -- FID ------------------------------------------------------------------------


def test_fid_statistics_and_distance_equal_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((300, 12)), rng.standard_normal((300, 12)) * 1.3 + 0.5
    for feats in (a, b):
        for got, want in zip(tfid.feature_statistics(feats), jfid.feature_statistics(feats)):
            np.testing.assert_array_equal(got, want)
    stats = [*tfid.feature_statistics(a), *tfid.feature_statistics(b)]
    assert tfid.frechet_distance(*stats) == jfid.frechet_distance(*stats)
    assert abs(tfid.frechet_distance(stats[0], stats[1], stats[0], stats[1])) < 1e-6


def test_compute_fid_matches_jax_on_the_same_features():
    """A fixed linear encoder (numpy on the JAX side, torch on the port's)
    over two streams of batches."""
    rng = np.random.default_rng(1)
    proj = rng.standard_normal((4 * 4 * 3, 10)).astype(np.float32)
    gen = [rng.random((8, 4, 4, 3)).astype(np.float32) for _ in range(4)]
    ref = [rng.random((8, 4, 4, 3)).astype(np.float32) ** 2 for _ in range(4)]
    want = jfid.compute_fid(lambda x: np.asarray(x).reshape(len(x), -1) @ proj, gen, ref)
    got = tfid.compute_fid(lambda x: x.reshape(len(x), -1) @ torch.from_numpy(proj), gen, ref,
                           device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want > 0.1


# -- VLM judges (host part) -----------------------------------------------------------


@pytest.mark.parametrize("text", ["85", " 72.5 ", "score: 101", "-3", "nan", "inf", "",
                                  "about 40 or 50", "1e3"])
def test_vlm_parsers_equal_jax(text):
    assert tvlm.parse_score(text) == jvlm.parse_score(text)
    assert tvlm.parse_score_strict(text) == jvlm.parse_score_strict(text)


def test_vlm_judge_and_edit_scorer_equal_jax():
    """Prompts, retries and fallbacks: a scripted generator fails twice,
    answers garbage, then a number; the same script drives both."""
    assert tvlm.SIMILARITY_DIMENSIONS == jvlm.SIMILARITY_DIMENSIONS

    def scripted():
        calls = []

        def generate(pred, target, prompt):
            calls.append(prompt)
            n = len(calls)
            if n % 4 == 1:
                raise RuntimeError("service down")
            if n % 4 == 2:
                return "no idea"
            return f"{(n * 7.5 + float(pred.mean())) % 110:.2f}"

        return generate, calls

    rng = np.random.default_rng(2)
    pred, target = rng.random((3, 4, 4, 3)), rng.random((3, 4, 4, 3))
    for parse in ("parse_score", "parse_score_strict"):
        (jgen, jcalls), (tgen, tcalls) = scripted(), scripted()
        want = jvlm.make_vlm_judge(jgen, max_retries=3, parse=getattr(jvlm, parse))(pred, target)
        got = tvlm.make_vlm_judge(tgen, max_retries=3, parse=getattr(tvlm, parse))(pred, target)
        np.testing.assert_array_equal(got, want)
        assert tcalls == jcalls
    (jgen, jcalls), (tgen, tcalls) = scripted(), scripted()
    for instruction in ("make it blue", "add a hat"):
        assert (tvlm.make_edit_scorer(tgen, max_retries=2)(pred[0], instruction, target[0])
                == jvlm.make_edit_scorer(jgen, max_retries=2)(pred[0], instruction, target[0]))
    assert tcalls == jcalls


# -- the consistency harness ----------------------------------------------------------


def _png_dirs(tmp_path, n=7, size=(20, 24)):
    gen_dir, ref_dir = tmp_path / "gen", tmp_path / "ref"
    (gen_dir / "sub").mkdir(parents=True)
    (ref_dir / "sub").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(n):
        rel = f"sub/{i}.png" if i % 3 == 0 else f"{i}.png"
        img = rng.random((*size, 3))
        save_png(str(gen_dir / rel), img)
        save_png(str(ref_dir / rel), img if i == 0 else np.clip(img + 0.2 * rng.random(img.shape), 0, 1))
    save_png(str(gen_dir / "orphan.png"), rng.random((*size, 3)))
    (gen_dir / "bad.png").write_bytes(b"not a png")
    save_png(str(ref_dir / "bad.png"), rng.random((*size, 3)))
    return str(gen_dir), str(ref_dir)


@pytest.mark.parametrize("reward", ["image_psnr", "dino"])
@pytest.mark.parametrize("size", [None, (16, 12)], ids=["native", "lanczos"])
def test_evaluate_consistency_matches_jax(tmp_path, reward, size):
    gen_dir, ref_dir = _png_dirs(tmp_path)
    assert tcons.pair_images(gen_dir, ref_dir) == jcons.pair_images(gen_dir, ref_dir)
    if reward == "dino":
        jmodel, params, tmodel = _dino_pair()
        jfn = jreg.make_reward_fn("dino", jreg.RewardModel(encode=jvit.make_encoder(jmodel, params)))
        tfn = treg.make_reward_fn("dino", treg.RewardModel(encode=tvit.make_encoder(tmodel)))
    else:
        jfn, tfn = jreg.make_reward_fn(reward), treg.make_reward_fn(reward)
    want = jcons.evaluate_consistency(jfn, gen_dir, ref_dir, batch_size=3, size=size)
    got = tcons.evaluate_consistency(tfn, gen_dir, ref_dir, batch_size=3, size=size,
                                     output_json=str(tmp_path / "stats.json"), device="cpu")
    for key in ("num_pairs", "num_scored", "num_errors"):
        assert got[key] == want[key], key
    assert got["num_scored"] == 7 and [e["path"] for e in got["errors"]] == ["bad.png"]
    for key in ("mean", "std", "min", "max", "median"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)
    assert json.loads((tmp_path / "stats.json").read_text())["num_scored"] == 7


def test_consistency_records_jpeg_and_mismatched_pairs(tmp_path):
    """No JPEG decoder in the port: a JPEG pair is one error record; a pair
    of another size falls back to item-by-item scoring and is recorded."""
    gen_dir, ref_dir = _png_dirs(tmp_path, n=3)
    (tmp_path / "gen" / "photo.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded")
    (tmp_path / "ref" / "photo.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded")
    save_png(str(tmp_path / "gen" / "odd.png"), np.zeros((8, 8, 3)))
    save_png(str(tmp_path / "ref" / "odd.png"), np.zeros((20, 24, 3)))
    stats = tcons.evaluate_consistency(treg.make_reward_fn("image_psnr"), gen_dir, ref_dir,
                                       batch_size=8, device="cpu")
    assert stats["num_pairs"] == 6 and stats["num_scored"] == 3
    assert sorted(e["path"] for e in stats["errors"]) == ["bad.png", "odd.png", "photo.jpg"]
    assert all(e["reason"] for e in stats["errors"])
    with world1_mesh() as mesh:  # the mesh path (pad, shard, gather) on one rank
        meshed = tcons.evaluate_consistency(treg.make_reward_fn("image_psnr"), gen_dir, ref_dir,
                                            batch_size=8, mesh=mesh)
    assert {k: v for k, v in meshed.items() if k != "errors"} == {
        k: v for k, v in stats.items() if k != "errors"}
    with pytest.raises(FileNotFoundError):
        tcons.evaluate_consistency(treg.make_reward_fn("image_psnr"), gen_dir,
                                   str(tmp_path / "empty"), device="cpu")


# -- the DINO PCA map ---------------------------------------------------------------------


def test_dino_vis_matches_jax():
    jmodel, params, tmodel = _dino_pair()
    feats = np.random.default_rng(4).standard_normal((16, 8))
    np.testing.assert_array_equal(tvis.pca_rgb(feats, (4, 4)), jvis.pca_rgb(feats, (4, 4)))
    img = np.random.default_rng(5).random((36, 44, 3)).astype(np.float32)
    got = tvis.visualize(tmodel, img)
    want = jvis.visualize(jmodel, params, img)
    assert got.shape == (2, 2, 3)
    # PCA is defined up to the sign of each component: compare |centred maps|
    centre = lambda m: np.abs(m - m.mean(axis=(0, 1)))  # noqa: E731
    np.testing.assert_allclose(centre(got), centre(want), **MODEL_TOL)


# -- the trainers on their production rewards --------------------------------------------


def _recorded(captured, jitted):
    """Wrap a reward to record its values (through a debug callback inside
    the JAX SD trainer's jitted decode-and-reward)."""
    def wrap(reward_fn):
        def reward(pred, target):
            r = reward_fn(pred, target)
            if jitted:
                jax.debug.callback(lambda x: captured.setdefault("rewards", []).append(
                    np.asarray(x)), r)
            else:
                captured.setdefault("rewards", []).append(
                    r.detach().numpy().copy() if torch.is_tensor(r) else np.asarray(r))
            return r

        return reward

    return wrap


def test_sd_train_step_on_depth_matches_jax(stacks, monkeypatch):  # noqa: F811
    """The SD trainer's production reward: depth PSNR through tiny
    Depth-Anything on the decoded 16 x 16 images."""
    jpipe, tpipe = sd_pipelines(stacks)
    jcfg, tcfg = sd_configs()
    jmodel, params, tmodel = _depth_pair()
    jreward = jreg.make_reward_fn("depth", jreg.RewardModel(depth=jda.make_depth_fn(jmodel, params)))
    treward = treg.make_reward_fn("depth", treg.RewardModel(depth=tda.make_depth_fn(tmodel)))
    jcap, tcap = {}, {}
    _capture(monkeypatch, jppo, jtrain, jcap)
    _capture(monkeypatch, tppo, ttrain, tcap)
    jtrainer = jtrain.PPOTrainer(jpipe, _recorded(jcap, True)(jreward), jcfg)
    ttrainer = ttrain.PPOTrainer(tpipe, _recorded(tcap, False)(treward), tcfg)
    from tests.test_torch_train import _batch as sd_batch

    batch = sd_batch()
    j_metrics = jtrainer.train_step(dict(batch))
    jax.effects_barrier()
    steps = inject_actions(monkeypatch, ttrainer.factor_net, jcap["traj"].actions)
    t_metrics = ttrainer.train_step(dict(batch))
    assert steps["i"] == jcap["traj"].actions.shape[1] + 1
    assert t_metrics["num_inference"] == j_metrics["num_inference"]
    np.testing.assert_array_equal(tcap["traj"].actions.numpy(), np.asarray(jcap["traj"].actions))
    np.testing.assert_allclose(tcap["old_probs"], jcap["old_probs"], **PROB_TOL)
    np.testing.assert_allclose(tcap["rewards"][0], jcap["rewards"][0], **REWARD_TOL)
    assert np.ptp(jcap["rewards"][0]) > 1e-3
    scale = jcfg.ppo.advantage_scale
    np.testing.assert_allclose(tcap["advantages"], jcap["advantages"], rtol=0, atol=2e-2 * scale)
    for name in ("loss", "policy_loss", "entropy", "ratio_mean", "grad_norm", "reward"):
        np.testing.assert_allclose(t_metrics[name], j_metrics[name], err_msg=name, **LOSS_TOL)
    assert_params_close(ttrainer.factor_net, jtrainer.params, tcfg.ppo.learning_rate)


def test_edit_train_step_on_dino_matches_jax(base, monkeypatch):  # noqa: F811
    """The FLUX trainer's production reward: DINO cosine through a tiny ViT
    on the decoded 16 x 16 images, for the policy rows and the Euler
    baseline."""
    jpipe, tpipe = edit_pipelines(base)
    jcfg, tcfg = edit_configs()
    jmodel, params, tmodel = _dino_pair()
    jreward = jreg.make_reward_fn("dino", jreg.RewardModel(encode=jvit.make_encoder(jmodel, params)))
    treward = treg.make_reward_fn("dino", treg.RewardModel(encode=tvit.make_encoder(tmodel)))
    jcap, tcap = {}, {}
    _capture(monkeypatch, jppo, jtrain_edit, jcap)
    _capture(monkeypatch, tppo, ttrain_edit, tcap)
    jtrainer = jtrain_edit.EditPPOTrainer(jpipe, _recorded(jcap, False)(jreward), jcfg)
    ttrainer = ttrain_edit.EditPPOTrainer(tpipe, _recorded(tcap, False)(treward), tcfg)
    j_metrics = jtrainer.train_step(edit_batch())
    steps = inject_actions(monkeypatch, ttrainer.factor_net, jcap["traj"].actions)
    t_metrics = ttrainer.train_step(edit_batch())
    assert steps["i"] == jcap["traj"].actions.shape[1] + 1
    assert t_metrics["num_inference"] == j_metrics["num_inference"]
    np.testing.assert_allclose(tcap["old_probs"], jcap["old_probs"], **PROB_TOL)
    for got, want in zip(tcap["rewards"], jcap["rewards"], strict=True):  # policy, then baseline
        np.testing.assert_allclose(got, want, **REWARD_TOL)
    assert np.ptp(jcap["rewards"][0]) > 1e-4
    np.testing.assert_allclose(tcap["advantages"], jcap["advantages"], rtol=0, atol=2e-2)
    for name in ("loss", "policy_loss", "entropy", "ratio_mean", "grad_norm", "reward",
                 "baseline_reward"):
        np.testing.assert_allclose(t_metrics[name], j_metrics[name], err_msg=name, **LOSS_TOL)
    assert_params_close(ttrainer.factor_net, jtrainer.params, tcfg.ppo.learning_rate)
