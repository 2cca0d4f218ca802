"""consolver_torch.policy.factor_net against the JAX FactorNet, with the same
(non-zero, random) weights carried across by load_jax_params.

Tolerance: f32 MLP of three small matmuls on the CPU, 1e-5.  The FM family
divides logits by its 0.01 temperature, which scales logit rounding by 100,
so its log-probabilities hold 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from consolver_torch.models.convert import load_jax_params
from consolver_torch.policy.factor_net import FactorNet as TFactorNet
from consolver_torch.policy.factor_net import FactorNetConfig as TConfig
from consolver_torch.policy.factor_net import _cosine_features as t_cosine
from consolver_tpu.policy.factor_net import FactorNet as JFactorNet
from consolver_tpu.policy.factor_net import FactorNetConfig as JConfig
from consolver_tpu.policy.factor_net import _cosine_features as j_cosine

CONFIGS = [
    dict(order_dim=4, scaler_dim=0, num_actions=11, family="sd"),
    dict(order_dim=4, scaler_dim=2, num_actions=11, family="sd", use_conv=True),
    dict(order_dim=2, scaler_dim=2, num_actions=21, family="sd"),
    dict(order_dim=3, scaler_dim=1, mu_dim=1, num_actions=11, family="fm", use_conv=True),
]


def _random_params(jnet, seed):
    """JAX init, then every leaf (the zero-init head too) set random."""
    params = jnet.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32), params
    )


def _pair(kwargs, seed=0):
    jnet = JFactorNet(JConfig(**kwargs))
    params = _random_params(jnet, seed)
    tnet = load_jax_params(TFactorNet(TConfig(**kwargs), device="cpu"), params)
    return jnet, params, tnet


def _conds(cfg_kwargs, batch=5, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1000, (batch, 2)).astype(np.float32)
    eps = rng.standard_normal((batch, cfg_kwargs["order_dim"], 4, 4, 2)).astype(np.float32)
    return {"x": x, "epsilon": eps}


def _tconds(conds):
    return {k: torch.from_numpy(v) for k, v in conds.items()}


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_grid_and_config_match(kwargs):
    np.testing.assert_array_equal(
        TConfig(**kwargs).action_value_grid(), JConfig(**kwargs).action_value_grid()
    )
    t, j = TConfig(**kwargs), JConfig(**kwargs)
    assert (t.action_dims, t.input_dim, t.input_scale, t.temperature) == (
        j.action_dims, j.input_dim, j.input_scale, j.temperature
    )


def test_sd_head_is_zero_initialised():
    net = TFactorNet(TConfig(order_dim=4, scaler_dim=0, num_actions=11), device="cpu")
    assert not net.head.weight.any() and not net.head.bias.any()
    probs = net.probs({"x": torch.tensor([[999.0, 874.0]])})
    np.testing.assert_allclose(probs.detach().numpy(), 1 / 11, rtol=1e-6)


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_log_probs_mode_and_action_probs_match(kwargs):
    jnet, params, tnet = _pair(kwargs)
    conds = _conds(kwargs)
    tol = 1e-4 if kwargs["family"] == "fm" else 1e-5
    with torch.no_grad():
        t_logp = tnet.log_probs(_tconds(conds)).numpy()
        j_logp = np.asarray(jnet.log_probs(params, conds))
        np.testing.assert_allclose(t_logp, j_logp, rtol=tol, atol=tol)

        t_vals, t_probs = tnet.mode_action(_tconds(conds))
        j_vals, j_probs = jnet.mode_action(params, conds)
        np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
        np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), rtol=tol, atol=tol)

        # actions off the grid re-index to the nearest grid point
        rng = np.random.default_rng(2)
        actions = np.asarray(j_vals) + rng.uniform(-0.01, 0.01, j_vals.shape).astype(np.float32)
        t_sel, t_ent = tnet.get_action_probs(_tconds(conds), torch.from_numpy(actions))
        j_sel, j_ent = jnet.get_action_probs(params, conds, actions)
        np.testing.assert_array_equal(
            tnet.actions_to_indices(torch.from_numpy(actions)).numpy(),
            np.asarray(jnet.actions_to_indices(actions)),
        )
        np.testing.assert_allclose(t_sel.numpy(), np.asarray(j_sel), rtol=tol, atol=tol)
        np.testing.assert_allclose(t_ent.numpy(), np.asarray(j_ent), rtol=tol, atol=tol)


def test_cosine_features_match():
    rng = np.random.default_rng(5)
    eps = rng.standard_normal((3, 4, 8, 8, 4)).astype(np.float32)
    eps[1, 2] = 0.0  # a zero slot hits the eps clamp
    np.testing.assert_allclose(
        t_cosine(torch.from_numpy(eps), 4).numpy(), np.asarray(j_cosine(eps, 4)),
        rtol=1e-5, atol=1e-6,
    )


def test_sample_action_on_grid_with_matching_probs():
    kwargs = CONFIGS[1]
    _, _, tnet = _pair(kwargs)
    conds = _tconds(_conds(kwargs, batch=64))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        values, probs = tnet.sample_action(conds, gen)
        logp = tnet.log_probs(conds)
    idx = tnet.actions_to_indices(values)
    # every sampled value is exactly a grid point of its dimension
    grid = tnet.action_values
    dims = torch.arange(grid.shape[0])[None, :]
    np.testing.assert_array_equal(values.numpy(), grid[dims, idx].numpy())
    np.testing.assert_allclose(
        probs.numpy(), logp.exp().gather(-1, idx[..., None])[..., 0].numpy(), rtol=1e-6
    )
    # the same generator seed draws the same actions; another seed differs
    again, _ = tnet.sample_action(conds, torch.Generator().manual_seed(0))
    other, _ = tnet.sample_action(conds, torch.Generator().manual_seed(1))
    assert torch.equal(values, again) and not torch.equal(values, other)


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_sample_action_is_torch_multinomial_draw(kwargs):
    """The one draw path (argmax of p / q, q ~ Exp(1), from the generator)
    takes the indices torch.multinomial takes for one sample on the same
    generator state, bit for bit; a shard of the global draw
    (ShardedGenerator) keeps the global draw's rows."""
    from consolver_torch.policy.factor_net import ShardedGenerator

    _, _, tnet = _pair(kwargs)
    conds = _tconds(_conds(kwargs, batch=12))
    with torch.no_grad():
        probs = tnet.log_probs(conds).exp()
        b, a, n = probs.shape
        for seed in range(4):
            want = torch.multinomial(probs.reshape(b * a, n), 1,
                                     generator=torch.Generator().manual_seed(seed))
            values, _ = tnet.sample_action(conds, torch.Generator().manual_seed(seed))
            np.testing.assert_array_equal(tnet.actions_to_indices(values).numpy(),
                                          want.reshape(b, a).numpy())
            shard = {k: v[4:8] for k, v in conds.items()}
            part, _ = tnet.sample_action(
                shard, ShardedGenerator(torch.Generator().manual_seed(seed), 4, b))
            assert torch.equal(part, values[4:8])
