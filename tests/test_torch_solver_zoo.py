"""consolver_torch's baseline solver zoo against the JAX package's.

The solvers run on one fake epsilon model, the same numpy-defined function
of (x, t) on both sides (a well-posed denoiser predicting ``x0 = tanh(x)``),
from the same f32 start, at every step count each solver allows.  The
stochastic variants get the JAX package's per-step draws
(``normal(fold_in(key, i))``) through the port's ``noise_fn``.  Tolerance:
1e-5 of the latents' scale (f32 on the CPU; both sides apply the same
float64 coefficients as Python floats).  Through the tiny pipeline the
zoo is held at the slice tolerance of ``tests/test_torch_pipeline.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.core import schedules as tschedules
from consolver_torch.pipelines import solver_zoo as tzoo
from consolver_tpu.core import schedules
from consolver_tpu.pipelines import solver_zoo as jzoo
from tests.test_torch_pipeline import TOL, _inputs, _pipelines, stacks  # noqa: F401

JSCHED = schedules.DiffusionSchedule.sd15()
TSCHED = tschedules.DiffusionSchedule.sd15()
ZOO_ATOL = 1e-5
STEP_COUNTS = (1, 2, 5, 8, 16)
KEY = jax.random.key(7)


def eps_model(xp, x, t):
    """A denoiser predicting ``x0 = tanh(x)``, consistent with the forward
    process at ``t`` (``xp`` is jax.numpy or torch)."""
    abar = float(JSCHED.alphas_cumprod[int(t)])
    return (x - abar**0.5 * xp.tanh(x)) / (1 - abar) ** 0.5


def jax_draw(i, shape):
    return np.array(jax.random.normal(jax.random.fold_in(KEY, i), shape, jnp.float32))


def torch_noise_fn(i, shape):
    return torch.from_numpy(jax_draw(i, shape))


def _start(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 4, 4, 4)).astype(np.float32)


def _run_pair(jsolver, tsolver, x):
    np.testing.assert_array_equal(tsolver.timesteps, jsolver.timesteps)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i, t in enumerate(jsolver.timesteps):
        jx = jsolver.step(i, jx, eps_model(jnp, jx, t))
        tx = tsolver.step(i, tx, eps_model(torch, tx, t))
    assert tx.dtype == torch.float32
    want = np.asarray(jx)
    # 1e-5 of the latents' scale (1 for all but the eps-space sde solver's
    # few-step runs, which end far from the data)
    np.testing.assert_allclose(tx.numpy(), want, rtol=0,
                               atol=ZOO_ATOL * max(1.0, float(np.abs(want).max())))


ZOO_CASES = [(name, steps) for name in tzoo.SOLVERS if name != "amed" for steps in STEP_COUNTS]
ZOO_CASES += [("amed", steps) for steps in sorted(tzoo.AMED_SCHEDULES)]


@pytest.mark.parametrize("name,steps", ZOO_CASES)
def test_zoo_solver_matches_jax(name, steps):
    stochastic = name.startswith("sde-")
    jsolver = jzoo.make_solver(name, JSCHED, steps, noise_key=KEY if stochastic else None)
    tsolver = tzoo.make_solver(name, TSCHED, steps,
                               noise_fn=torch_noise_fn if stochastic else None)
    _run_pair(jsolver, tsolver, _start(steps))


@pytest.mark.parametrize("steps", [8, 16])
@pytest.mark.parametrize("kind", ["dpmsolver", "dpmsolver++", "unipc"])
def test_third_order_matches_jax(kind, steps):
    if kind == "unipc":
        pair = (jzoo.UniPC(JSCHED, steps, solver_order=3), tzoo.UniPC(TSCHED, steps, solver_order=3))
    else:
        pair = (jzoo.DpmMultistep(JSCHED, steps, algorithm=kind, solver_order=3),
                tzoo.DpmMultistep(TSCHED, steps, algorithm=kind, solver_order=3))
    _run_pair(*pair, _start(30 + steps))


@pytest.mark.parametrize("name", ["ddim", "dmd2"])
@pytest.mark.parametrize("steps", [2, 8])
def test_ddim_eta_matches_jax_with_its_draws(name, steps):
    jsolver = jzoo.make_solver(name, JSCHED, steps, noise_key=KEY, eta=0.6)
    tsolver = tzoo.make_solver(name, TSCHED, steps, noise_fn=torch_noise_fn, eta=0.6)
    _run_pair(jsolver, tsolver, _start(40 + steps))


def test_coefficients_stay_f32():
    """Coefficients enter as Python floats: an f32 state stays f32 (a 0-d
    float64 numpy factor would promote it)."""
    x = torch.ones((1, 4))
    for name in tzoo.SOLVERS:
        steps = 4
        solver = tzoo.make_solver(name, TSCHED, steps, noise_fn=lambda i, s: torch.zeros(s))
        y = x
        for i in range(len(solver.timesteps)):
            y = solver.step(i, y, y * 0.5)
        assert y.dtype == torch.float32, name


def test_amed_snap_matches_jax():
    for steps in tzoo.AMED_SCHEDULES:
        j, t = jzoo.amed_solver(JSCHED, steps), tzoo.amed_solver(TSCHED, steps)
        np.testing.assert_array_equal(t.timesteps, j.timesteps)
        np.testing.assert_array_equal(t.sigmas, j.sigmas)


def test_unsupported_arguments_raise():
    with pytest.raises(ValueError, match="AMED"):
        tzoo.amed_solver(TSCHED, 5)
    with pytest.raises(ValueError, match="AMED"):
        tzoo.make_solver("amed", TSCHED, 7)
    with pytest.raises(ValueError, match="eta"):
        tzoo.make_solver("unipc", TSCHED, 4, eta=0.5)
    with pytest.raises(ValueError, match="noise_fn"):
        tzoo.make_solver("sde-dpmsolver++", TSCHED, 4)
    with pytest.raises(ValueError, match="noise_fn"):
        tzoo.make_solver("ddim", TSCHED, 4, eta=0.5)
    with pytest.raises(ValueError, match="Unknown solver"):
        tzoo.make_solver("dpmsolver++", TSCHED, 4)
    with pytest.raises(ValueError, match="generator"):
        tzoo.make_baseline_denoise_fn(lambda x, t, c: x, TSCHED, "sde-dpmsolver", 2)(
            None, torch.zeros((1, 2)), torch.zeros((1, 1)), torch.zeros((1, 1)))


def test_ipndm_calls_the_model_once_per_schedule_entry():
    calls = []

    def unet(x, t, ctx):
        calls.append(int(t[0]))
        return torch.zeros_like(x)

    fn = tzoo.make_baseline_denoise_fn(unet, TSCHED, "ipndm", 5, guidance_scale=3.0)
    fn(None, torch.zeros((1, 2, 2, 4)), torch.zeros((1, 3, 8)), torch.zeros((1, 3, 8)))
    assert len(calls) == len(tzoo.make_solver("ipndm", TSCHED, 5).timesteps) == 6


@pytest.mark.parametrize("name", jzoo.SOLVERS)
def test_zoo_denoise_fn_matches_jax(name):
    """The CFG-batched loop of ``make_baseline_denoise_fn`` on a model that
    reads x, t and the context, the sde variants with the JAX draws."""
    rng = np.random.default_rng(5)
    noise = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    ctx, unc = (rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(2))
    steps = 4

    def model(xp):
        table = xp.asarray(JSCHED.alphas_cumprod)

        def apply(x, t, c):  # t is a traced array on the JAX side
            abar = table[t].reshape(-1, 1, 1, 1)
            shift = c.mean(axis=(1, 2)) if xp is jnp else c.mean(dim=(1, 2))
            return ((x - xp.sqrt(abar) * xp.tanh(x)) / xp.sqrt(1 - abar)
                    + 0.1 * shift.reshape(-1, 1, 1, 1))
        return apply

    jfn = jzoo.make_baseline_denoise_fn(lambda p, x, t, c: model(jnp)(x, t, c), JSCHED, name,
                                        steps, guidance_scale=3.0)
    args = (jnp.asarray(noise), jnp.asarray(ctx), jnp.asarray(unc))
    want = jfn(None, KEY, *args) if name.startswith("sde-") else jfn(None, *args)
    tfn = tzoo.make_baseline_denoise_fn(model(torch), TSCHED, name, steps, guidance_scale=3.0,
                                        noise_fn=torch_noise_fn)
    got = tfn(None, *map(torch.from_numpy, (noise, ctx, unc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", [n for n in jzoo.SOLVERS if not n.startswith("sde-")])
def test_zoo_through_the_pipeline_matches_jax(stacks, name):  # noqa: F811
    """The tiny TextToImagePipeline with a zoo solver: latents and images
    against the JAX pipeline; the policy is not consulted."""
    jpipe, tpipe = _pipelines(stacks, dict(order_dim=2, scaler_dim=0, num_actions=11))
    ids, noise = _inputs()
    kwargs = dict(num_inference_steps=4, solver=name)
    j_img, j_traj = jpipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise), **kwargs)
    j_lat, _ = jpipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise), decode=False,
                     **kwargs)
    t_img, t_traj = tpipe(None, ids, noise, **kwargs)
    t_lat, _ = tpipe(None, ids, noise, decode=False, **kwargs)
    assert t_traj is None and j_traj is None
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), **TOL)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), **TOL)
    # a zoo program ignores the determinism knob: one cache entry for both
    tpipe(None, ids, noise, deterministic_policy=True, **kwargs)
    # keys end (solver, record, deterministic)
    assert len([k for k in tpipe.programs if k[-3] == name]) == 1


@pytest.mark.parametrize("name", ["sde-dpmsolver", "sde-dpmsolver++"])
def test_sde_through_the_pipeline_draws_from_the_generator(stacks, name):  # noqa: F811
    _, tpipe = _pipelines(stacks, dict(order_dim=2, scaler_dim=0, num_actions=11))
    ids, noise = _inputs()

    def run(seed):
        lat, traj = tpipe(torch.Generator().manual_seed(seed), ids, noise, num_inference_steps=4,
                          solver=name, decode=False)
        assert traj is None
        return lat

    a, b, a2 = run(1), run(2), run(1)
    assert torch.isfinite(a).all() and torch.equal(a, a2) and not torch.equal(a, b)
