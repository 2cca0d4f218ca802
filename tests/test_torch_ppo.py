"""The PPO machinery, the rewards and the group data of consolver_torch
against the JAX package, on the same numpy inputs (f32 on the CPU).

Tolerances: advantages 1e-6 (times the advantage scale: the std's sum
order differs); flattening exact; the loss, its aux and its
gradients 1e-5 (``jax.grad`` against autograd through the same MLP); the
optimizer 1e-6 relative (atol 1e-6 of the largest element) on the Adam
moments after 5 calls fed identical gradients, and on the parameters with atol ``5e-5 lr`` (optax's
bias correction in f32, below); reward metrics 1e-5; group picks and dataset order exact.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consolver_torch.data import group as tgroup
from consolver_torch.dist.mesh import make_grad_sync
from consolver_torch.models.convert import load_jax_params
from consolver_torch.pipelines.t2i import Trajectory as TTrajectory
from consolver_torch.policy.factor_net import FactorNet as TFactorNet
from consolver_torch.policy.factor_net import FactorNetConfig as TFConfig
from consolver_torch.rewards import metrics as tmetrics
from consolver_torch.rewards import registry as tregistry
from consolver_torch.rl import ppo as tppo
from consolver_tpu.data import group as jgroup
from consolver_tpu.pipelines.t2i import Trajectory as JTrajectory
from consolver_tpu.policy.factor_net import FactorNet, FactorNetConfig
from consolver_tpu.rewards import metrics as jmetrics
from consolver_tpu.rewards import registry as jregistry
from consolver_tpu.rl import ppo as jppo
from tests.torch_dist_workers import world1_mesh

FNET = dict(order_dim=3, scaler_dim=1, num_actions=7, hidden_dim=16, family="sd")


def _rewards(groups, per_group=5, seed=0, equal_group=None):
    r = np.random.default_rng(seed).uniform(10, 30, (groups, per_group)).astype(np.float32)
    if equal_group is not None:
        r[equal_group] = 17.25
    return r.reshape(-1)


@pytest.mark.parametrize("groups,equal", [(1, None), (1, 0), (4, None), (4, 2)])
def test_group_advantages(groups, equal):
    r = _rewards(groups, equal_group=equal)
    want = np.asarray(jppo.group_advantages(jnp.asarray(r), 10.0, num_groups=groups))
    got = tppo.group_advantages(torch.from_numpy(r), 10.0, num_groups=groups).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 10.0)  # 1e-6 of the scale
    if equal is not None:  # a group of equal rewards: std 0, advantages 0
        assert not got.reshape(groups, -1)[equal].any()


@pytest.mark.parametrize("groups,equal", [(1, None), (1, 0), (4, None), (4, 1)])
def test_baseline_clipped_advantages(groups, equal):
    r = _rewards(groups, seed=1, equal_group=equal)
    # one baseline above its group's mean, one below, one above the 100 clip
    base = np.array([25.0, 5.0, 150.0, 20.0][:groups], np.float32)
    want = np.asarray(jppo.baseline_clipped_advantages(jnp.asarray(r), jnp.asarray(base),
                                                        num_groups=groups))
    got = tppo.baseline_clipped_advantages(torch.from_numpy(r), torch.from_numpy(base),
                                           num_groups=groups).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if groups == 1:  # a scalar baseline
        got = tppo.baseline_clipped_advantages(torch.from_numpy(r), 25.0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _trajectory(rng, b=3, s=4, a=4, order_dim=3, eps=True, valid=True):
    fields = dict(
        conds_x=rng.uniform(0, 999, (b, s, 2)).astype(np.float32),
        actions=rng.uniform(-1, 1, (b, s, a)).astype(np.float32),
        probs=rng.uniform(0.05, 1, (b, s, a)).astype(np.float32),
        masks=(rng.uniform(size=(b, s, a)) > 0.3).astype(np.float32),
    )
    if eps:
        fields["conds_eps"] = rng.standard_normal((b, s, order_dim, 2, 2, 1)).astype(np.float32)
    if valid:
        fields["valid"] = (rng.uniform(size=(b, s)) > 0.4).astype(np.float32)
    return fields


@pytest.mark.parametrize("with_valid", [False, True])
def test_flatten_trajectory(with_valid):
    rng = np.random.default_rng(2)
    fields = _trajectory(rng, valid=with_valid)
    adv = rng.standard_normal(3).astype(np.float32)
    want = jppo.flatten_trajectory(JTrajectory(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                   jnp.asarray(adv))
    got = tppo.flatten_trajectory(TTrajectory(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                                  torch.from_numpy(adv))
    assert set(got[0]) == set(want[0]) == {"x", "epsilon"}
    for name in ("x", "epsilon"):
        np.testing.assert_array_equal(got[0][name].numpy(), np.asarray(want[0][name]))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _policies(seed=0, **overrides):
    kwargs = {**FNET, **overrides}
    jnet = FactorNet(FactorNetConfig(**kwargs))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
                          jnet.init(jax.random.key(seed)))
    return jnet, params, load_jax_params(TFactorNet(TFConfig(**kwargs), device="cpu"), params)


def _ppo_batch(jnet, params, rng, n=24, valid=True):
    conds = {"x": rng.uniform(0, 999, (n, 2)).astype(np.float32)}
    actions, probs = jnet.sample_action(params, jax.random.key(3), {"x": jnp.asarray(conds["x"])})
    old = np.asarray(probs) * rng.uniform(0.6, 1.4, probs.shape).astype(np.float32)
    adv = rng.standard_normal((n, 1)).astype(np.float32) * (rng.uniform(size=(n, 3)) > 0.2)
    w = (rng.uniform(size=(n, 1)) > 0.3).astype(np.float32) if valid else None
    return conds, np.asarray(actions), old.astype(np.float32), adv.astype(np.float32), w


def _torch_tree(module, tree):
    """A JAX-layout tree (params or gradients) as the port's state dict."""
    return load_jax_params(TFactorNet(module.config, device="cpu"), tree).state_dict()


@pytest.mark.parametrize("with_valid", [False, True])
def test_ppo_loss_and_gradients(with_valid):
    jnet, params, tnet = _policies()
    rng = np.random.default_rng(4)
    conds, actions, old, adv, w = _ppo_batch(jnet, params, rng, valid=with_valid)

    def jloss(p):
        return jppo.ppo_loss(jnet, p, {"x": jnp.asarray(conds["x"])}, jnp.asarray(actions),
                             jnp.asarray(old), jnp.asarray(adv), 0.2, 0.01,
                             valid=None if w is None else jnp.asarray(w))

    (j_loss, j_aux), j_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    t_loss, t_aux = tppo.ppo_loss(
        tnet, {"x": torch.from_numpy(conds["x"])}, torch.from_numpy(actions), torch.from_numpy(old),
        torch.from_numpy(adv), 0.2, 0.01, valid=None if w is None else torch.from_numpy(w))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5, atol=1e-5)
    for name in ("policy_loss", "entropy", "ratio_mean", "loss"):
        np.testing.assert_allclose(t_aux[name].item(), float(j_aux[name]), rtol=1e-5, atol=1e-5)
    want = _torch_tree(tnet, j_grads)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["below_max_norm", "above_max_norm"])
def test_optimizer_matches_optax(k, grad_scale):
    """5 calls with identical gradients: parameters and Adam moments."""
    jnet, params, tnet = _policies(seed=1)
    config = tppo.PPOConfig(learning_rate=1e-3, weight_decay=1e-2, grad_accumulation_steps=k)
    jopt = jppo.make_optimizer(jppo.PPOConfig(**vars(config)))
    jstate = jopt.init(params)
    topt = tppo.make_optimizer(tnet, config)
    rng = np.random.default_rng(5)
    norms = []
    for _ in range(5):
        grads = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * grad_scale).astype(np.float32), params)
        norms.append(float(optax.global_norm(grads)))
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        for name, g in _torch_tree(tnet, grads).items():
            tnet.get_parameter(name).grad = g.clone()
        topt.step()
    assert all(n < 1.0 for n in norms) if grad_scale < 1 else all(n > 1.0 for n in norms)
    # optax takes Adam's bias correction 1 - b2^t in f32 (1.3e-5 off at
    # t = 1, 6.4e-6 after the square root), torch in double: each of the 5
    # calls may move a parameter by that share of lr more or less.
    want = _torch_tree(tnet, params)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                   rtol=1e-6, atol=5 * 1e-5 * config.learning_rate)
    # A moment is a running sum of gradients of either sign, so an element
    # near 0 carries the rounding of the larger ones: atol is 1e-6 of the
    # tensor's largest element.
    for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = _torch_tree(tnet, optax.tree_utils.tree_get(jstate, key))
        for name, p in tnet.named_parameters():
            got, ref = topt.adamw.state[p][moment].numpy(), want[name].numpy()
            np.testing.assert_allclose(got, ref, err_msg=f"{key} {name}", rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())
    assert topt.mini_step == 5 % k


def test_accumulation_holds_parameters_between_applies():
    _, _, tnet = _policies(seed=2)
    topt = tppo.make_optimizer(tnet, tppo.PPOConfig(grad_accumulation_steps=3))
    before = [p.detach().clone() for p in tnet.parameters()]
    for call in range(3):
        for p in tnet.parameters():
            p.grad = torch.ones_like(p) * (call + 1)
        topt.step()
        same = all(torch.equal(p, b) for p, b in zip(tnet.parameters(), before))
        assert same == (call < 2)
    assert all(not a.any() for a in topt.acc_grads)


@pytest.mark.parametrize("adv_scale", [1.0, 1000.0])
def test_update_reports_the_norm_before_the_clip(adv_scale):
    jnet, params, tnet = _policies(seed=3)
    rng = np.random.default_rng(6)
    conds, actions, old, adv, w = _ppo_batch(jnet, params, rng)
    adv = adv * adv_scale
    j_opt = jppo.make_optimizer(jppo.PPOConfig())
    update = jppo.make_update_fn(jnet, j_opt, jppo.PPOConfig())
    _, _, j_aux = update(params, j_opt.init(params), {"x": jnp.asarray(conds["x"])},
                         jnp.asarray(actions), jnp.asarray(old), jnp.asarray(adv), jnp.asarray(w))
    t_opt = tppo.make_optimizer(tnet, tppo.PPOConfig())
    t_update = tppo.make_update_fn(tnet, t_opt, tppo.PPOConfig())
    t_aux = t_update({"x": torch.from_numpy(conds["x"])}, torch.from_numpy(actions),
                     torch.from_numpy(old), torch.from_numpy(adv), torch.from_numpy(w))
    np.testing.assert_allclose(float(t_aux["grad_norm"]), float(j_aux["grad_norm"]), rtol=1e-5)
    assert (float(t_aux["grad_norm"]) > 1.0) == (adv_scale > 1)
    # a one-rank data-parallel update is the plain update
    _, _, dp_net = _policies(seed=3)
    dp_opt = tppo.make_optimizer(dp_net, tppo.PPOConfig())
    with world1_mesh() as mesh:
        dp_update = tppo.make_update_fn(dp_net, dp_opt, tppo.PPOConfig(),
                                        grad_sync=make_grad_sync(mesh))
        dp_aux = dp_update({"x": torch.from_numpy(conds["x"])}, torch.from_numpy(actions),
                           torch.from_numpy(old), torch.from_numpy(adv), torch.from_numpy(w))
    for name, value in t_aux.items():
        np.testing.assert_allclose(float(dp_aux[name]), float(value), rtol=1e-6, err_msg=name)
    for a, b in zip(dp_net.parameters(), tnet.parameters(), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7)


def _images(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (3, 8, 8, 3)).astype(dtype), rng.uniform(0, 1, (3, 8, 8, 3)).astype(dtype))


def test_reward_metrics_match_jax():
    pred, target = _images(7)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 3, 16)).astype(np.float32)
    depth = rng.uniform(0, 5, (2, 3, 8, 8)).astype(np.float32)
    masks = rng.integers(0, 4, (2, 3, 8, 8))
    proj = rng.standard_normal((8 * 8 * 3, 5)).astype(np.float32)
    cases = [
        ("image_psnr_reward", (pred, target), {}),
        ("image_psnr_reward", (pred, pred), {}),  # mse 0: clamped to 100
        ("feature_cosine_reward", (feats[0], feats[1]), {}),
        ("_minmax_normalize", (depth[0],), {}),
        ("depth_psnr_reward", (depth[0], depth[1]), {}),
        ("segmentation_reward", (masks[0], masks[1]), {}),
    ]
    for name, args, _ in cases:
        want = np.asarray(getattr(jmetrics, name)(*map(jnp.asarray, args)))
        got = getattr(tmetrics, name)(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
    want = jmetrics.encoder_cosine_reward(lambda x: x.reshape(x.shape[0], -1) @ proj,
                                          jnp.asarray(pred), jnp.asarray(target))
    got = tmetrics.encoder_cosine_reward(lambda x: x.reshape(x.shape[0], -1) @ torch.from_numpy(proj),
                                         torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_images_give_bf16_psnr_as_in_jax():
    pred, target = _images(9)
    want = jmetrics.image_psnr_reward(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target, jnp.bfloat16))
    got = tmetrics.image_psnr_reward(torch.from_numpy(pred).bfloat16(), torch.from_numpy(target).bfloat16())
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7)


@pytest.mark.parametrize("reward_type", jregistry.REWARD_TYPES)
def test_registry_dispatch_and_errors_match(reward_type):
    assert tregistry.REWARD_TYPES == jregistry.REWARD_TYPES
    if reward_type == "image_psnr":
        assert tregistry.make_reward_fn(reward_type) is tmetrics.image_psnr_reward
        return
    with pytest.raises(ValueError) as j_err:
        jregistry.make_reward_fn(reward_type)
    with pytest.raises(ValueError) as t_err:
        tregistry.make_reward_fn(reward_type)
    first = str(j_err.value).split(" (")[0]
    assert str(t_err.value).startswith(first)


def test_registry_callables_and_unported_encoders():
    pred, target = _images(10)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    model = tregistry.RewardModel(
        encode=lambda x: x.mean(dim=(1, 2)), depth=lambda x: x.mean(dim=-1),
        segment=lambda x: (x[..., 0] > 0.5).long(),
        vlm_judge=lambda p, t: np.abs(p - t).mean(axis=(1, 2, 3)))
    for name, want in (("dino", tmetrics.feature_cosine_reward(tp.mean(dim=(1, 2)), tt.mean(dim=(1, 2)))),
                       ("depth", tmetrics.depth_psnr_reward(tp.mean(dim=-1), tt.mean(dim=-1))),
                       ("segmentation", tmetrics.segmentation_reward((tp[..., 0] > 0.5).long(),
                                                                     (tt[..., 0] > 0.5).long()))):
        torch.testing.assert_close(tregistry.make_reward_fn(name, model)(tp, tt), want)
    judge = tregistry.make_reward_fn("qwen_vl", model)
    assert judge.host_side and judge(tp, tt).dtype == torch.float32
    np.testing.assert_allclose(judge(tp, tt).numpy(), np.abs(pred - target).mean(axis=(1, 2, 3)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown reward type"):
        tregistry.make_reward_fn("lpips")
    # the encoders are ported now (tests/test_torch_backbones.py holds them
    # against JAX); an unknown type still raises as the JAX registry does
    assert tregistry.build_encoder_for("dino", None, device="meta").model.cfg.hidden_size == 768
    with pytest.raises(ValueError, match="no feature encoder"):
        tregistry.build_encoder_for("segmentation", None, device="meta")
    with pytest.raises(ValueError, match="no feature encoder"):
        jregistry.build_encoder_for("segmentation", None)


@pytest.mark.parametrize("num_groups", [1, 2, 5])
def test_group_picks_bit_equal(num_groups):
    rng = np.random.default_rng(11)
    batch = {"noise": rng.standard_normal((10, 2, 2, 4)).astype(np.float32),
             "prompt_ids": rng.integers(0, 99, (10, 6))}
    for step in range(4):
        want = jgroup.repeat_random_sample_groups(batch, random.Random(f"7-group-{step}"), num_groups)
        got = tgroup.repeat_random_sample_groups(batch, random.Random(f"7-group-{step}"), num_groups)
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k])
    one = tgroup.repeat_random_sample(batch, random.Random(3))
    np.testing.assert_array_equal(one["noise"], jgroup.repeat_random_sample(batch, random.Random(3))["noise"])
    with pytest.raises(ValueError, match="not divisible"):
        tgroup.repeat_random_sample_groups(batch, random.Random(0), 3)


def test_teacher_dataset_order_and_nan_resampling(tmp_path):
    rng = np.random.default_rng(12)
    for i in range(7):
        latent = rng.standard_normal((2, 2, 4)).astype(np.float32)
        if i in (2, 5):
            latent[0, 0, 0] = np.nan
        np.savez(os.path.join(tmp_path, f"{i:06d}.npz"), noise=rng.standard_normal((2, 2, 4)),
                 latent=latent, prompt_ids=np.full(4, i))
    (tmp_path / "000003.npz").write_bytes(b"not a zip")  # corrupt: resampled too
    j_ds, t_ds = jgroup.TeacherDataset(str(tmp_path)), tgroup.TeacherDataset(str(tmp_path))
    assert len(t_ds) == len(j_ds) == 7
    for shuffle in (False, True):
        want = list(j_ds.batches(3, seed=4, shuffle=shuffle))
        got = list(t_ds.batches(3, seed=4, shuffle=shuffle))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    for idx in (2, 3, 5):  # each replaced by a clean sample
        assert not np.isnan(t_ds[idx]["latent"]).any()
        np.testing.assert_array_equal(t_ds[idx]["prompt_ids"], j_ds[idx]["prompt_ids"])
