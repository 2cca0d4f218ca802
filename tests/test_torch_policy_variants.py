"""consolver_torch's policy variants (``policy/continuous.py``,
``policy/mu_net.py``) against the JAX package's: the six cases of
``tests/test_policy_variants.py`` on the port, with the JAX weights carried
by ``load_jax_params``; means, stds, densities, entropies and log-probs equal
to JAX's within 1e-6, and MuNet's grid equal to the reference grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.models.convert import load_jax_params
from consolver_torch.policy.continuous import ContinuousFactorNet as TContinuous
from consolver_torch.policy.continuous import ContinuousFactorNetConfig as TContinuousConfig
from consolver_torch.policy.mu_net import MuNet as TMuNet
from consolver_torch.rl import ppo as tppo
from consolver_tpu.policy.continuous import ContinuousFactorNet, ContinuousFactorNetConfig
from consolver_tpu.policy.mu_net import MuNet


def _perturbed(params, seed=3, scale=0.02):
    """The JAX tree with every leaf moved off its init (the head is zero),
    by about a trained head's size, so that the means stay O(1)."""
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def _continuous(perturb=False, **kw):
    jnet = ContinuousFactorNet(ContinuousFactorNetConfig(order_dim=4, scaler_dim=0,
                                                         family="sd", **kw))
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(0)))
    if perturb:
        params = _perturbed(params)
    tnet = TContinuous(TContinuousConfig(order_dim=4, scaler_dim=0, family="sd", **kw),
                       device="cpu")
    return jnet, params, load_jax_params(tnet, params)


class TestContinuous:
    def test_zero_init_mean(self):
        _, _, net = _continuous()
        mean, std = net.dist({"x": torch.tensor([[999.0, 874.0]])})
        assert torch.count_nonzero(mean) == 0
        np.testing.assert_allclose(std.detach().numpy(), np.exp(-1.0), rtol=1e-5)

    def test_sample_within_bounds(self):
        _, _, net = _continuous()
        conds = {"x": torch.tensor([[500.0, 400.0]]).repeat(256, 1)}
        actions, dens = net.sample_action(conds, torch.Generator().manual_seed(1))
        assert (actions >= net.low[None] - 1e-6).all() and (actions <= net.high[None] + 1e-6).all()
        assert (dens > 0).all()

    def test_density_roundtrip_and_ppo_compat(self):
        """Densities from sampling equal those of re-evaluation at the stored
        (clipped) actions, clipped samples included: the first PPO ratio is 1."""
        _, _, net = _continuous()
        conds = {"x": torch.tensor([[100.0, 50.0]]).repeat(64, 1)}
        actions, dens = net.sample_action(conds, torch.Generator().manual_seed(2))
        dens2, entropy = net.get_action_probs(conds, actions)
        clipped = (actions <= net.low[None] + 1e-6) | (actions >= net.high[None] - 1e-6)
        assert clipped.any()
        torch.testing.assert_close(dens, dens2, rtol=1e-5, atol=0)
        expected = 0.5 * np.log(2 * np.pi * np.e * np.exp(-2.0))
        np.testing.assert_allclose(entropy.detach().numpy(), expected, rtol=1e-5)

    def test_ppo_update_works(self):
        """The port's PPO loss and optimizer move the Gaussian mean up when
        the first coefficient is rewarded."""
        _, _, net = _continuous()
        conds = {"x": torch.tensor([[500.0, 400.0]]).repeat(128, 1)}
        pcfg = tppo.PPOConfig(learning_rate=5e-3, entropy_coef=0.0)
        update = tppo.make_update_fn(net, tppo.make_optimizer(net, pcfg), pcfg)
        gen = torch.Generator().manual_seed(3)
        for _ in range(20):
            with torch.no_grad():
                actions, dens = net.sample_action(conds, gen)
            adv = tppo.group_advantages(actions[:, 0], scale=1.0).reshape(-1, 1)
            update(conds, actions, dens, adv)
        mean, _ = net.dist(conds)
        assert float(mean[0, 0].detach()) > 0.05

    @pytest.mark.parametrize("use_conv", [False, True])
    def test_matches_jax(self, use_conv):
        jnet, params, tnet = _continuous(perturb=True, use_conv=use_conv)
        rng = np.random.default_rng(4)
        x = rng.uniform(0, 999, (16, 2)).astype(np.float32)
        conds_np = {"x": x}
        if use_conv:
            conds_np["epsilon"] = rng.standard_normal((16, 4, 2, 3, 3)).astype(np.float32)
        jconds = {k: jnp.asarray(v) for k, v in conds_np.items()}
        tconds = {k: torch.from_numpy(v) for k, v in conds_np.items()}
        jmean, jstd = jnet._dist(params, jconds)
        tmean, tstd = tnet.dist(tconds)
        np.testing.assert_allclose(tmean.detach().numpy(), np.asarray(jmean), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tstd.detach().numpy(), np.asarray(jstd), rtol=1e-6, atol=1e-6)
        actions, _ = jnet.sample_action(params, jax.random.key(5), jconds)
        jdens, jent = jnet.get_action_probs(params, jconds, actions)
        tdens, tent = tnet.get_action_probs(tconds, torch.from_numpy(np.array(actions)))
        np.testing.assert_allclose(tdens.detach().numpy(), np.asarray(jdens), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tent.detach().numpy(), np.asarray(jent), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tnet.low.numpy(), np.asarray(jnet.low))
        np.testing.assert_array_equal(tnet.high.numpy(), np.asarray(jnet.high))


class TestMuNet:
    def _pair(self):
        jnet = MuNet()
        params = _perturbed(jax.tree.map(np.asarray, jnet.init(jax.random.key(0))))
        return jnet, params, load_jax_params(TMuNet(device="cpu"), params)

    def test_sample_and_grid(self):
        _, _, net = self._pair()
        x = torch.ones((8, 1))
        actions, probs = net.sample_action(x, torch.Generator().manual_seed(1))
        grid = net.action_values.numpy()
        assert all(np.isclose(grid, a).any() for a in actions.numpy())
        p2, entropy = net.get_action_probs(x, actions)
        torch.testing.assert_close(probs, p2, rtol=1e-5, atol=0)
        assert (entropy <= 1.0 + 1e-5).all()

    def test_grid_matches_reference(self):
        net = TMuNet(device="cpu")
        np.testing.assert_allclose(net.action_values.numpy(), np.linspace(1.0, 2.0, 21), rtol=1e-6)
        np.testing.assert_array_equal(net.action_values.numpy(), np.asarray(MuNet().action_values))

    def test_matches_jax(self):
        jnet, params, tnet = self._pair()
        x = np.random.default_rng(6).uniform(-2, 2, (32, 1)).astype(np.float32)
        jlogp = jnet.log_probs(params, jnp.asarray(x))
        tlogp = tnet.log_probs(torch.from_numpy(x))
        np.testing.assert_allclose(tlogp.detach().numpy(), np.asarray(jlogp), rtol=1e-6, atol=1e-6)
        actions, _ = jnet.sample_action(params, jax.random.key(7), jnp.asarray(x))
        jp, jent = jnet.get_action_probs(params, jnp.asarray(x), actions)
        tp, tent = tnet.get_action_probs(torch.from_numpy(x), torch.from_numpy(np.array(actions)))
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tent.detach().numpy(), np.asarray(jent), rtol=1e-6, atol=1e-6)
