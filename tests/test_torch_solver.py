"""consolver_torch.core (schedules + LMM solver) against the JAX package and
the list-based reference emulator.

Tolerance: f32 on the CPU on both sides; the same few multiply-adds in
another order, so 1e-6 relative / 1e-6 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.core import schedules as tschedules
from consolver_torch.core import solver as tsolver
from consolver_tpu.core import schedules as jschedules
from consolver_tpu.core import solver as jsolver
from tests.reference_emulator import ListLMM, ddim_update_np

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_schedule_tables_match(kind):
    j = jschedules.DiffusionSchedule.create(beta_schedule=kind)
    t = tschedules.DiffusionSchedule.create(beta_schedule=kind)
    np.testing.assert_array_equal(t.betas, j.betas)
    np.testing.assert_array_equal(t.alphas_cumprod, j.alphas_cumprod)
    assert t.final_alpha_cumprod == j.final_alpha_cumprod
    sd = tschedules.DiffusionSchedule.sd15()
    np.testing.assert_array_equal(sd.alphas_cumprod, jschedules.DiffusionSchedule.sd15().alphas_cumprod)


@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing"])
@pytest.mark.parametrize("steps", [1, 3, 8, 16])
def test_spaced_timesteps_match(spacing, steps):
    np.testing.assert_array_equal(
        tschedules.spaced_timesteps(1000, steps, spacing, 1),
        jschedules.spaced_timesteps(1000, steps, spacing, 1),
    )


def _torch_step(state, eps, actions, sample, order_dim, scaler_dim):
    """The pipeline's per-step solver sequence on the port's functions."""
    state = tsolver.push(state, eps)
    order_a, scale_a, _ = tsolver.split_actions(actions, order_dim, scaler_dim)
    coeffs = tsolver.normalized_coefficients(order_a, state.num_ets, order_dim)
    eff = tsolver.combine(state, coeffs)
    eff, sample = tsolver.apply_scalers(eff, sample, scale_a)
    masks = tsolver.warmup_masks(state.num_ets, order_dim, actions.shape[1], actions.shape[0])
    return state, eff, sample, masks, coeffs


@pytest.mark.parametrize("order_dim", [1, 2, 4])
@pytest.mark.parametrize("scaler_dim", [0, 2])
def test_lmm_matches_jax_and_emulator(order_dim, scaler_dim):
    """Warm-up through a full ring (and past it), step by step."""
    rng = np.random.default_rng(order_dim * 10 + scaler_dim)
    batch, shape = 3, (4, 4, 2)
    a_dims = order_dim + scaler_dim - 1
    emulator = ListLMM(order_dim, scaler_dim)
    jstate = jsolver.init_state(batch, order_dim, shape)
    tstate = tsolver.init_state(batch, order_dim, shape)
    sample = rng.standard_normal((batch, *shape)).astype(np.float32)
    for _ in range(order_dim + 3):
        eps = rng.standard_normal((batch, *shape)).astype(np.float32)
        actions = (rng.standard_normal((batch, a_dims)) * 0.5).astype(np.float32)
        ref_eff, ref_sample, ref_masks = emulator.step(eps, sample, actions)
        jstate, j_eff, j_sample, j_masks = jsolver.lmm_combine_step(
            jstate, jnp.asarray(eps), jnp.asarray(actions), jnp.asarray(sample),
            order_dim, scaler_dim,
        )
        tstate, t_eff, t_sample, t_masks, t_coeffs = _torch_step(
            tstate, torch.from_numpy(eps), torch.from_numpy(actions),
            torch.from_numpy(sample), order_dim, scaler_dim,
        )
        assert tstate.num_ets == int(jstate.num_ets)
        np.testing.assert_allclose(tstate.ets.numpy(), np.asarray(jstate.ets), **TOL)
        np.testing.assert_allclose(t_eff.numpy(), np.asarray(j_eff), **TOL)
        np.testing.assert_allclose(t_eff.numpy(), ref_eff, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_sample.numpy(), ref_sample, **TOL)
        np.testing.assert_array_equal(t_masks.numpy(), np.asarray(j_masks))
        np.testing.assert_array_equal(t_masks.numpy(), ref_masks)
        j_coeffs = jsolver.normalized_coefficients(
            jnp.asarray(actions[:, : order_dim - 1]), jstate.num_ets, order_dim
        )
        np.testing.assert_allclose(t_coeffs.numpy(), np.asarray(j_coeffs), **TOL)


def test_first_step_passthrough_and_closing_coefficient():
    """num_ets == 1 passes the raw output through; the closing 1 - prefix
    applies only once num_ets > 1."""
    actions = torch.full((2, 3), 0.7)
    c1 = tsolver.normalized_coefficients(actions, 1, 4)
    np.testing.assert_allclose(c1.numpy(), [[1.7, 0.7, 0.7, 0.7]] * 2, rtol=1e-6)
    c3 = tsolver.normalized_coefficients(actions, 3, 4)
    np.testing.assert_allclose(c3[:, :3].sum(1).numpy(), 1.0, rtol=1e-6)
    state = tsolver.push(tsolver.init_state(2, 4, (3,)), torch.full((2, 3), 2.5))
    np.testing.assert_allclose(tsolver.combine(state, c1).numpy(), 2.5)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_update_and_alpha_gather(prediction_type):
    """Includes the last step of the 8-step trailing ladder (t_prev = -1),
    which takes final_alpha_cumprod."""
    rng = np.random.default_rng(3)
    sched = tschedules.DiffusionSchedule.sd15()
    alphas_t = torch.from_numpy(sched.alphas_cumprod)
    alphas_j = jnp.asarray(sched.alphas_cumprod)
    ts = tschedules.spaced_timesteps(1000, 8, "trailing")
    prevs = ts - 125
    assert prevs[-1] == -1
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    for t, tp in zip(ts, prevs):
        ta, tprev = tsolver.gather_alpha_prods(alphas_t, int(t), int(tp), sched.final_alpha_cumprod)
        ja, jprev = jsolver.gather_alpha_prods(alphas_j, jnp.asarray(t), jnp.asarray(tp), sched.final_alpha_cumprod)
        assert float(ta) == float(ja) and float(tprev) == float(jprev)
        out_t = tsolver.ddim_update(torch.from_numpy(x), torch.from_numpy(eps), ta, tprev, prediction_type)
        out_j = jsolver.ddim_update(jnp.asarray(x), jnp.asarray(eps), ja, jprev, prediction_type)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
        if prediction_type == "epsilon":
            ref = ddim_update_np(x, eps, float(ta), float(tprev))
            np.testing.assert_allclose(out_t.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert float(tprev) == sched.final_alpha_cumprod


def test_add_noise_matches():
    rng = np.random.default_rng(4)
    sched = tschedules.DiffusionSchedule.sd15()
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    n = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    t = np.array([999, 500, 0])
    out_t = tsolver.add_noise(torch.from_numpy(sched.alphas_cumprod), torch.from_numpy(x),
                              torch.from_numpy(n), torch.from_numpy(t))
    out_j = jsolver.add_noise(jnp.asarray(sched.alphas_cumprod), jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
