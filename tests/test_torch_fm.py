"""consolver_torch's flow-matching half (sigma schedules, FM solver helpers,
the learnable FM loop in its per-count, padded and per-token programs, and
the four baseline solvers) against the JAX package, with stub velocities.

The policy takes mode actions (``deterministic_policy=True``) with random
head weights (std 0.3), so both sides pick the same actions.  Tolerances:
the sigma ladders are the same numpy code, so they are equal; the solver
helpers and the loops are f32 on the CPU on both sides (the same few
multiply-adds, 1e-6), with the loops' stub velocities adding sin() from two
libraries (1e-5).  The recorded probabilities hold 1e-3: the FM policy
divides its logits by the temperature 0.01, which turns 1e-6 differences in
the cosine features of the history into 1e-4 in a probability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.core import schedules as tsched
from consolver_torch.core import solver as tsolver
from consolver_torch.models.convert import load_jax_params
from consolver_torch.pipelines import fm as tfm
from consolver_torch.policy.factor_net import FactorNet as TFactorNet
from consolver_torch.policy.factor_net import FactorNetConfig as TFConfig
from consolver_tpu.core import schedules as jsched
from consolver_tpu.core import solver as jsolver
from consolver_tpu.pipelines import fm as jfm
from consolver_tpu.policy.factor_net import FactorNet, FactorNetConfig

TOL = dict(rtol=1e-6, atol=1e-6)
LOOP_TOL = dict(rtol=1e-5, atol=1e-5)
PROBS_TOL = dict(rtol=1e-3, atol=1e-3)
FM_CONFIGS = {
    "flux": dict(use_dynamic_shifting=True),
    "static_shift3": dict(shift=3.0),
    "terminal": dict(shift=3.0, shift_terminal=0.05),
    "karras": dict(use_karras_sigmas=True, shift=2.0),
    "exponential": dict(use_exponential_sigmas=True),
    "beta": dict(use_beta_sigmas=True),
    "inverted": dict(invert_sigmas=True),
    "linear_shift": dict(use_dynamic_shifting=True, time_shift_type="linear"),
}
POLICIES = {
    "flux_ppo": dict(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11, family="fm"),
    "mu_dim": dict(order_dim=2, scaler_dim=0, mu_dim=1, num_actions=11, family="fm"),
    "order3_conv": dict(order_dim=3, scaler_dim=2, num_actions=11, family="fm", use_conv=True),
}


def _configs(name):
    kw = FM_CONFIGS[name]
    return jsched.FlowMatchConfig(**kw), tsched.FlowMatchConfig(**kw)


def _policy(kwargs, seed=0):
    jnet = FactorNet(FactorNetConfig(**kwargs))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
                          jnet.init(jax.random.key(seed)))
    return jnet, params, load_jax_params(TFactorNet(TFConfig(**kwargs), device="cpu"), params)


def _j_vel(params, x, t, cond):
    return jnp.sin(x) * 0.3 - 0.2 * x + 1e-3 * t.reshape((-1,) + (1,) * (x.ndim - 1))


def _t_vel(x, t, cond):
    return torch.sin(x) * 0.3 - 0.2 * x + 1e-3 * t.reshape((-1,) + (1,) * (x.ndim - 1))


def _assert_traj(t_traj, j_traj, fields):
    for name in fields:
        t, j = getattr(t_traj, name), getattr(j_traj, name)
        assert t.shape == j.shape, name
        if name in ("probs", "conds_eps"):
            tol = PROBS_TOL if name == "probs" else LOOP_TOL
            np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("name", list(FM_CONFIGS))
@pytest.mark.parametrize("steps", [2, 4, 6])
def test_fm_sigmas_match(name, steps):
    jcfg, tcfg = _configs(name)
    mu = jsched.calculate_flux_mu(4096) if jcfg.use_dynamic_shifting else None
    assert tsched.calculate_flux_mu(4096) == mu or mu is None
    js, jt = jsched.fm_sigmas(jcfg, steps, mu=mu)
    ts, tt = tsched.fm_sigmas(tcfg, steps, mu=mu)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tt, jt)
    assert tsched.FlowMatchConfig.flux() == tsched.FlowMatchConfig(
        **{f: getattr(jsched.FlowMatchConfig.flux(), f) for f in ("use_dynamic_shifting",
                                                                   "base_shift", "max_shift")})


def test_shift_helpers_match():
    t = np.linspace(0.05, 1.0, 9)
    np.testing.assert_array_equal(tsched.static_shift(t, 3.0), jsched.static_shift(t, 3.0))
    for kind in ("exponential", "linear"):
        np.testing.assert_array_equal(tsched.time_shift(0.8, 1.0, t, kind),
                                      jsched.time_shift(0.8, 1.0, t, kind))
    np.testing.assert_array_equal(tsched.stretch_shift_to_terminal(t[::-1], 0.02),
                                  jsched.stretch_shift_to_terminal(t[::-1], 0.02))
    for fn in ("convert_to_karras", "convert_to_exponential", "convert_to_beta"):
        np.testing.assert_array_equal(getattr(tsched, fn)(t[::-1], 5), getattr(jsched, fn)(t[::-1], 5))
    for seq in (256, 1024, 4096, 8192):
        assert tsched.calculate_flux_mu(seq) == jsched.calculate_flux_mu(seq)
    with pytest.raises(ValueError, match="mu"):
        tsched.fm_sigmas(tsched.FlowMatchConfig.flux(), 4)


@pytest.mark.parametrize("order_dim,scaler_dim,mu_dim", [(2, 0, 0), (2, 0, 1), (3, 2, 1), (1, 0, 0)])
def test_split_actions_and_lmm_combine_step_match(order_dim, scaler_dim, mu_dim):
    rng = np.random.default_rng(order_dim + 3 * scaler_dim + 7 * mu_dim)
    batch, shape = 2, (3, 4)
    a_dims = order_dim + scaler_dim + mu_dim - 1
    jst = jsolver.init_state(batch, order_dim, shape)
    tst = tsolver.init_state(batch, order_dim, shape)
    sample = rng.standard_normal((batch,) + shape).astype(np.float32)
    for _ in range(order_dim + 1):
        out = rng.standard_normal((batch,) + shape).astype(np.float32)
        actions = rng.uniform(-1, 1, (batch, max(a_dims, 0))).astype(np.float32)
        for j, t in zip(jsolver.split_actions(jnp.asarray(actions), order_dim, scaler_dim, mu_dim),
                        tsolver.split_actions(torch.from_numpy(actions), order_dim, scaler_dim, mu_dim)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        jst, j_eff, j_smp, j_masks = jsolver.lmm_combine_step(
            jst, jnp.asarray(out), jnp.asarray(actions), jnp.asarray(sample), order_dim, scaler_dim)
        tst, t_eff, t_smp, t_masks = tsolver.lmm_combine_step(
            tst, torch.from_numpy(out), torch.from_numpy(actions), torch.from_numpy(sample),
            order_dim, scaler_dim)
        np.testing.assert_allclose(t_eff.numpy(), np.asarray(j_eff), **TOL)
        np.testing.assert_allclose(t_smp.numpy(), np.asarray(j_smp), **TOL)
        np.testing.assert_array_equal(t_masks.numpy(), np.asarray(j_masks))
        assert tst.num_ets == int(jst.num_ets)


def test_fm_update_helpers_match():
    rng = np.random.default_rng(5)
    x, v, n = (rng.standard_normal((2, 6, 4)).astype(np.float32) for _ in range(3))
    sigma = np.asarray([0.7, 0.2], np.float32)
    np.testing.assert_allclose(
        tsolver.fm_euler_update(torch.from_numpy(x), torch.from_numpy(v), -0.125).numpy(),
        np.asarray(jsolver.fm_euler_update(jnp.asarray(x), jnp.asarray(v), -0.125)), **TOL)
    np.testing.assert_allclose(
        tsolver.fm_scale_noise(torch.from_numpy(sigma), torch.from_numpy(x), torch.from_numpy(n)).numpy(),
        np.asarray(jsolver.fm_scale_noise(jnp.asarray(sigma), jnp.asarray(x), jnp.asarray(n))), **TOL)
    ladder, _ = jsched.fm_sigmas(jsched.FlowMatchConfig(shift=3.0), 4)
    ptts = rng.choice(np.concatenate([ladder, [0.5, 0.01]]), (2, 6)).astype(np.float32) * 1000
    for j, t in zip(jsolver.per_token_sigma_pair(jnp.asarray(ptts), jnp.asarray(ladder)),
                    tsolver.per_token_sigma_pair(torch.from_numpy(ptts), torch.from_numpy(ladder))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_allclose(
        tsolver.fm_per_token_update(torch.from_numpy(x), torch.from_numpy(v),
                                    torch.from_numpy(ptts), torch.from_numpy(ladder)).numpy(),
        np.asarray(jsolver.fm_per_token_update(jnp.asarray(x), jnp.asarray(v), jnp.asarray(ptts),
                                               jnp.asarray(ladder))), **TOL)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("config", ["flux", "static_shift3"])
def test_learnable_loop_matches_jax(policy, config):
    jcfg, tcfg = _configs(config)
    mu = jsched.calculate_flux_mu(1024) if jcfg.use_dynamic_shifting else None
    jnet, params, tnet = _policy(POLICIES[policy], seed=len(policy))
    noise = np.random.default_rng(1).standard_normal((3, 16, 8)).astype(np.float32)
    j_fn = jfm.make_fm_denoise_fn(_j_vel, jcfg, jnet, 5, mu=mu, deterministic_policy=True)
    t_fn = tfm.make_fm_denoise_fn(_t_vel, tcfg, tnet, 5, mu=mu, deterministic_policy=True)
    j_out, j_traj = j_fn(None, params, jax.random.key(0), jnp.asarray(noise), None)
    with torch.no_grad():
        t_out, t_traj = t_fn(None, torch.from_numpy(noise), None)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LOOP_TOL)
    fields = ("conds_x", "actions", "probs", "masks") + (
        ("conds_eps",) if POLICIES[policy].get("use_conv") else ())
    _assert_traj(t_traj, j_traj, fields)
    assert t_traj.valid is None


def test_learnable_loop_without_record_or_policy():
    _, tcfg = _configs("static_shift3")
    jcfg, _ = _configs("static_shift3")
    noise = np.random.default_rng(2).standard_normal((2, 8)).astype(np.float32)
    j_out, j_traj = jfm.make_fm_denoise_fn(_j_vel, jcfg, None, 3, record_trajectory=False)(
        None, None, jax.random.key(0), jnp.asarray(noise), None)
    t_out, t_traj = tfm.make_fm_denoise_fn(_t_vel, tcfg, None, 3, record_trajectory=False)(
        None, torch.from_numpy(noise), None)
    assert j_traj is None and t_traj is None
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LOOP_TOL)


@pytest.mark.parametrize("policy", ["flux_ppo", "order3_conv"])
def test_padded_loop_matches_jax(policy):
    """3 real steps in a 5-step padded program: pad steps pass state
    through, their masks are zero and ``valid`` marks them; the padded
    program equals the per-count one."""
    jcfg, tcfg = _configs("flux")
    mu = jsched.calculate_flux_mu(256)
    jnet, params, tnet = _policy(POLICIES[policy], seed=4)
    noise = np.random.default_rng(3).standard_normal((2, 8, 4)).astype(np.float32)
    j_ladder = jfm.padded_fm_ladder(jcfg, 3, 5, mu=mu)
    t_ladder = tfm.padded_fm_ladder(tcfg, 3, 5, mu=mu)
    for j, t in zip(j_ladder, t_ladder):
        np.testing.assert_array_equal(t, np.asarray(j))
    j_out, j_traj = jfm.make_padded_fm_denoise_fn(_j_vel, jcfg, jnet, 5, deterministic_policy=True)(
        None, params, jax.random.key(0), jnp.asarray(noise), None, *j_ladder)
    t_pad = tfm.make_padded_fm_denoise_fn(_t_vel, tcfg, tnet, 5, deterministic_policy=True)
    with torch.no_grad():
        t_out, t_traj = t_pad(None, torch.from_numpy(noise), None, *t_ladder)
        c_out, _ = tfm.make_fm_denoise_fn(_t_vel, tcfg, tnet, 3, mu=mu, deterministic_policy=True)(
            None, torch.from_numpy(noise), None)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LOOP_TOL)
    fields = ("conds_x", "actions", "probs", "masks", "valid") + (
        ("conds_eps",) if POLICIES[policy].get("use_conv") else ())
    _assert_traj(t_traj, j_traj, fields)
    np.testing.assert_array_equal(t_traj.valid[0].numpy(), [1, 1, 0, 0])
    np.testing.assert_array_equal(t_out.numpy(), c_out.numpy())
    with pytest.raises(ValueError, match="ladder"):
        t_pad(None, torch.from_numpy(noise), None, *tfm.padded_fm_ladder(tcfg, 3, 4, mu=mu))


def test_per_token_loop_matches_jax():
    jcfg, tcfg = _configs("static_shift3")
    jnet, params, tnet = _policy(POLICIES["flux_ppo"], seed=2)
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((2, 6, 4)).astype(np.float32)
    sigmas, _ = jsched.fm_sigmas(jcfg, 4)
    ptts = np.tile([sigmas[0], sigmas[1], sigmas[2], 0.0, sigmas[0], sigmas[3]],
                   (2, 1)).astype(np.float32) * 1000
    j_out, j_traj = jfm.make_fm_denoise_fn(_j_vel, jcfg, jnet, 4, per_token=True,
                                           deterministic_policy=True)(
        None, params, jax.random.key(0), jnp.asarray(noise), None, jnp.asarray(ptts))
    t_fn = tfm.make_fm_denoise_fn(_t_vel, tcfg, tnet, 4, per_token=True, deterministic_policy=True)
    with torch.no_grad():
        t_out, t_traj = t_fn(None, torch.from_numpy(noise), None, torch.from_numpy(ptts))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LOOP_TOL)
    _assert_traj(t_traj, j_traj, ("conds_x", "actions", "probs", "masks"))
    np.testing.assert_array_equal(t_out[:, 3].numpy(), noise[:, 3])  # at sigma 0: fixed
    with pytest.raises(ValueError, match="per_token_timesteps"):
        t_fn(None, torch.from_numpy(noise), None)


@pytest.mark.parametrize("solver_type", jfm.FM_SOLVERS)
@pytest.mark.parametrize("steps", [3, 4])
def test_baselines_match_jax(solver_type, steps):
    jcfg, tcfg = _configs("flux")
    mu = jsched.calculate_flux_mu(1024)
    noise = np.random.default_rng(6).standard_normal((2, 8, 4)).astype(np.float32)
    j_out = jfm.make_fm_baseline_denoise_fn(_j_vel, jcfg, solver_type, steps, mu=mu)(
        None, jnp.asarray(noise), None)
    t_out = tfm.make_fm_baseline_denoise_fn(_t_vel, tcfg, solver_type, steps, mu=mu)(
        torch.from_numpy(noise), None)
    assert t_out.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LOOP_TOL)


def test_baseline_rejects_unknown_solver():
    with pytest.raises(ValueError, match="Unknown FM solver"):
        tfm.make_fm_baseline_denoise_fn(_t_vel, tsched.FlowMatchConfig(), "unipc", 3)
