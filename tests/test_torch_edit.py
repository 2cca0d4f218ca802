"""The edit slice: consolver_torch's FluxKontextPipeline against the JAX
package's on the tiny stack of ``tests/test_edit.py::make_tiny_flux_pipeline``
(T5 + CLIP prompt encoding, VAE encode of the reference image, the packed
Kontext DiT loop with the FM FactorNet or a baseline, VAE decode), with the
same weights, ids, reference image and noise.

The policy takes mode actions (``deterministic_policy=True``) with random
head weights (std 0.3), so both sides pick the same actions, which must be
equal.  Tolerance 2e-4 on latents, images and probabilities (f32 on the
CPU): each step runs the tiny DiT, whose guidance embedding sees arguments
of 2500 rad at guidance 2.5 (one f32 ulp there is 2.4e-4; the DiT alone
differs by up to 3.5e-5), and true-CFG 3 amplifies a step's difference 5x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.core import schedules as tsched
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
from consolver_tpu.pipelines.edit import FluxKontextPipeline as JPipe
from tests.test_edit import make_tiny_flux_pipeline

TOL = dict(rtol=2e-4, atol=2e-4)
FNET = dict(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11, family="fm")


@pytest.fixture(scope="module")
def pipes():
    """Both pipelines with the tiny stack's weights and one std-0.3 policy."""
    base = make_tiny_flux_pipeline()
    rng = np.random.default_rng(0)
    fparams = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
                           base.factor_params)
    jpipe = JPipe(base.transformer, base.transformer_params, base.t5, base.t5_params, base.clip,
                  base.clip_params, base.vae, base.vae_params, factor_net=base.factor_net,
                  factor_params=fparams)
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


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    t5_ids = rng.integers(1, 64, (1, 4)).astype(np.int32)
    clip_ids = rng.integers(1, 64, (1, 4)).astype(np.int32)
    ref = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    return t5_ids, clip_ids, ref, noise


def _run_both(pipes, **kwargs):
    jpipe, tpipe = pipes
    args = _inputs()
    j_out, j_traj = jpipe(jax.random.key(0), *map(jnp.asarray, args), **kwargs)
    t_out, t_traj = tpipe(None, *args, **kwargs)
    return (t_out, t_traj), (np.asarray(j_out), j_traj)


def _assert_traj(t_traj, j_traj, fields):
    for name in fields:
        t, j = getattr(t_traj, name), getattr(j_traj, name)
        assert t.shape == j.shape, name
        if name == "probs":
            np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def test_encoders_and_vae_match(pipes):
    jpipe, tpipe = pipes
    t5_ids, clip_ids, ref, _ = _inputs()
    j_pe, j_pooled = jpipe.encode_prompt(jnp.asarray(t5_ids), jnp.asarray(clip_ids))
    with torch.no_grad():
        t_pe, t_pooled = tpipe.encode_prompt(torch.from_numpy(t5_ids), torch.from_numpy(clip_ids))
        t_lat = tpipe.encode_image(torch.from_numpy(ref))
        t_img = tpipe.decode_latents(t_lat, chunk=1)
    np.testing.assert_allclose(t_pe.numpy(), np.asarray(j_pe), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled), rtol=1e-5, atol=1e-5)
    j_lat = jpipe.encode_image(jnp.asarray(ref))
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), **TOL)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(jpipe.decode_latents(j_lat, chunk=1)), **TOL)
    assert tpipe.mu_for(128, 128) == jpipe.mu_for(128, 128)


@pytest.mark.parametrize("decode", [True, False])
def test_fmppo_edit_matches_jax(pipes, decode):
    (t_out, t_traj), (j_out, j_traj) = _run_both(
        pipes, num_inference_steps=3, deterministic_policy=True, decode=decode)
    assert t_out.shape == ((1, 16, 16, 3) if decode else (1, 8, 8, 4))
    np.testing.assert_allclose(t_out.numpy(), j_out, **TOL)
    _assert_traj(t_traj, j_traj, ("conds_x", "actions", "probs", "masks"))
    assert t_traj.actions.shape == (1, 2, 1)


def test_record_false_returns_no_trajectory(pipes):
    _, tpipe = pipes
    out, traj = tpipe(None, *_inputs(), num_inference_steps=2, deterministic_policy=True,
                      record=False, decode=False)
    assert traj is None and torch.isfinite(out).all()


@pytest.mark.parametrize("solver", ["euler", "heun", "dpm-solver-multistep"])
def test_baseline_edit_matches_jax(pipes, solver):
    (t_img, t_traj), (j_img, j_traj) = _run_both(pipes, num_inference_steps=4, solver=solver)
    assert t_traj is None and j_traj is None
    np.testing.assert_allclose(t_img.numpy(), j_img, **TOL)


def test_true_cfg_edit_matches_jax(pipes):
    """Negative prompt, true-CFG 3: the 2x-batched double forward."""
    rng = np.random.default_rng(9)
    neg_t5, neg_clip = (rng.integers(1, 64, (1, 4)).astype(np.int32) for _ in range(2))
    kwargs = dict(num_inference_steps=3, deterministic_policy=True, true_cfg_scale=3.0,
                  decode=False)
    (t_out, t_traj), (j_out, j_traj) = _run_both(
        pipes, neg_t5_ids=jnp.asarray(neg_t5), neg_clip_ids=jnp.asarray(neg_clip), **kwargs)
    np.testing.assert_allclose(t_out.numpy(), j_out, **TOL)
    _assert_traj(t_traj, j_traj, ("conds_x", "actions", "probs", "masks"))
    plain, _ = pipes[1](None, *_inputs(), num_inference_steps=3, deterministic_policy=True,
                        decode=False)
    assert not np.allclose(plain.numpy(), t_out.numpy())
    with pytest.raises(ValueError, match="neg_clip_ids"):
        pipes[1](None, *_inputs(), neg_t5_ids=neg_t5, true_cfg_scale=3.0)


@pytest.mark.parametrize("solver", ["fmppo", "euler"])
def test_padded_edit_matches_jax(pipes, solver):
    """3 real steps in a 5-step program: equal to JAX, and to the port's own
    per-count program."""
    kwargs = dict(num_inference_steps=3, deterministic_policy=True, decode=False, solver=solver)
    (t_out, t_traj), (j_out, j_traj) = _run_both(pipes, padded_max_steps=5, **kwargs)
    np.testing.assert_allclose(t_out.numpy(), j_out, **TOL)
    _assert_traj(t_traj, j_traj, ("conds_x", "actions", "probs", "masks", "valid"))
    np.testing.assert_array_equal(t_traj.valid[0].numpy(), [1, 1, 0, 0])
    per_count, _ = pipes[1](None, *_inputs(), **kwargs)
    np.testing.assert_array_equal(t_out.numpy(), per_count.numpy())


def test_unported_and_invalid_paths_raise(pipes):
    _, tpipe = pipes
    with pytest.raises(ValueError, match="bits"):
        tpipe.quantize(bits=3)
    with pytest.raises(ValueError, match="padded_max_steps"):
        tpipe(None, *_inputs(), padded_max_steps=4, solver="heun")
    assert tpipe.fm_config == tsched.FlowMatchConfig.flux()
