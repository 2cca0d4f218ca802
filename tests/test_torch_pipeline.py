"""The whole slice: consolver_torch's TextToImagePipeline against the JAX
package's on the tiny stack (CLIP text -> CFG UNet loop with the FactorNet
and LMM solver -> VAE decode), with the same weights, prompt ids and noise.

The policy takes mode actions (``deterministic_policy=True``) with random
non-zero head weights, so the argmax is not a tie and both sides pick the
same actions.  Tolerance: f32 on the CPU; each of the 3 steps runs the tiny
UNet twice (CFG 3 amplifies its 1e-5 differences 5x), so latents, images
and probabilities hold 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.core import schedules as tschedules
from consolver_torch.data import tokenizer as ttok
from consolver_torch.models.clip_text import ClipTextConfig as TClipConfig
from consolver_torch.models.clip_text import ClipTextEncoder as TClip
from consolver_torch.models.convert import load_jax_params
from consolver_torch.models.unet_2d import UNet2DCondition as TUNet
from consolver_torch.models.unet_2d import UNetConfig as TUNetConfig
from consolver_torch.models.vae import AutoencoderKL as TVae
from consolver_torch.models.vae import VaeConfig as TVaeConfig
from consolver_torch.pipelines import t2i as tt2i
from consolver_torch.policy.factor_net import FactorNet as TFactorNet
from consolver_torch.policy.factor_net import FactorNetConfig as TFConfig
from consolver_tpu.core import schedules
from consolver_tpu.data import tokenizer as jtok
from consolver_tpu.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_tpu.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_tpu.models.vae import AutoencoderKL, VaeConfig
from consolver_tpu.pipelines import t2i as jt2i
from consolver_tpu.policy.factor_net import FactorNet, FactorNetConfig

TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = ["a red fox in the snow", "an astronaut riding a horse"]


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape)).astype(np.float32), params
    )


def _factor(kwargs, seed):
    jnet = FactorNet(FactorNetConfig(**kwargs))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
        jnet.init(jax.random.key(seed)),
    )
    return jnet, params, load_jax_params(TFactorNet(TFConfig(**kwargs), device="cpu"), params)


@pytest.fixture(scope="module")
def stacks():
    """Both pipelines' models with one set of weights (JAX init, perturbed)."""
    kk = jax.random.split(jax.random.key(0), 4)
    ucfg, tcfg, vcfg = UNetConfig.tiny(), ClipTextConfig.tiny(), VaeConfig.tiny()
    unet, te, vae = UNet2DCondition(ucfg), ClipTextEncoder(tcfg), AutoencoderKL(vcfg)
    up = _perturb(jax.jit(unet.init)(kk[0], jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                                     jnp.zeros((1, 4, ucfg.cross_attention_dim))), 1)
    tp = _perturb(jax.jit(te.init)(kk[1], jnp.zeros((1, 4), jnp.int32)), 2)
    vp = _perturb(jax.jit(vae.init)(kk[2], jnp.zeros((1, 16, 16, 3)), kk[3]), 3)
    torch_models = (
        load_jax_params(TUNet(TUNetConfig.tiny(), device="cpu"), up),
        load_jax_params(TClip(TClipConfig.tiny(), device="cpu"), tp),
        load_jax_params(TVae(TVaeConfig.tiny(), device="cpu"), vp),
    )
    return (unet, up, te, tp, vae, vp), torch_models


def _pipelines(stacks, fkwargs, seed=7):
    (unet, up, te, tp, vae, vp), (tunet, tte, tvae) = stacks
    jnet, fparams, tnet = _factor(fkwargs, seed)
    jpipe = jt2i.TextToImagePipeline(
        unet, up, te, tp, vae, vp, schedules.DiffusionSchedule.sd15(),
        factor_net=jnet, factor_params=fparams,
    )
    tpipe = tt2i.TextToImagePipeline(
        tunet, tte, tvae, tschedules.DiffusionSchedule.sd15(), factor_net=tnet, device="cpu",
    )
    return jpipe, tpipe


def _inputs(batch=2, seed=11):
    ids = ttok.tokenize_batch(ttok.HashTokenizer(), PROMPTS[:batch], 77, vocab_size=1000)
    noise = np.random.default_rng(seed).standard_normal((batch, 8, 8, 4)).astype(np.float32)
    return ids, noise


def _assert_traj(t_traj, j_traj, fields):
    for name in fields:
        t, j = getattr(t_traj, name), getattr(j_traj, name)
        assert t.shape == j.shape, name
        if name in ("probs", "conds_eps"):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def test_tokenizer_and_uncond_ids_match(stacks):
    j = jtok.tokenize_batch(jtok.HashTokenizer(), PROMPTS, 77, vocab_size=1000)
    t = ttok.tokenize_batch(ttok.HashTokenizer(), PROMPTS, 77, vocab_size=1000)
    np.testing.assert_array_equal(t, j)
    u = ttok.uncond_input_ids(ttok.HashTokenizer(), 3, 77)
    np.testing.assert_array_equal(u, jtok.uncond_input_ids(jtok.HashTokenizer(), 3, 77))
    assert u[0, 0] == 1 and u[0, 1] == 2 and not u[:, 2:].any()  # [BOS, EOS, pad...]
    jpipe, tpipe = _pipelines(stacks, dict(order_dim=2, scaler_dim=0, num_actions=11))
    ids, _ = _inputs()
    np.testing.assert_array_equal(
        tpipe.uncond_ids_for(torch.from_numpy(ids)).numpy(), np.asarray(jpipe.uncond_ids_for(ids))
    )


def test_whole_slice_matches_jax(stacks):
    """Images, latents and the recorded trajectory of the 3-step CFG-3
    program."""
    jpipe, tpipe = _pipelines(stacks, dict(order_dim=4, scaler_dim=2, num_actions=11))
    ids, noise = _inputs()
    j_img, j_traj = jpipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise),
                          num_inference_steps=3, deterministic_policy=True)
    j_lat, _ = jpipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise),
                     num_inference_steps=3, deterministic_policy=True, decode=False)
    t_img, t_traj = tpipe(None, ids, noise, num_inference_steps=3, deterministic_policy=True)
    t_lat, _ = tpipe(None, ids, noise, num_inference_steps=3, deterministic_policy=True, decode=False)
    assert t_img.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), **TOL)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), **TOL)
    _assert_traj(t_traj, j_traj, ("conds_x", "actions", "probs", "masks"))
    assert t_traj.valid is None and t_traj.actions.shape == (2, 2, 5)


def test_padded_program_matches_jax(stacks):
    """3 real steps in a 5-step padded program, use_conv policy: pad steps
    pass state through, their masks are zero and valid marks them."""
    fk = dict(order_dim=3, scaler_dim=2, num_actions=11, use_conv=True)
    jpipe, tpipe = _pipelines(stacks, fk, seed=8)
    ids, noise = _inputs()
    j_lat, j_traj = jpipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise),
                          num_inference_steps=3, deterministic_policy=True,
                          padded_max_steps=5, decode=False)
    t_lat, t_traj = tpipe(None, ids, noise, num_inference_steps=3, deterministic_policy=True,
                          padded_max_steps=5, decode=False)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), **TOL)
    _assert_traj(t_traj, j_traj, ("conds_x", "actions", "probs", "masks", "valid", "conds_eps"))
    np.testing.assert_array_equal(t_traj.valid[0].numpy(), [1, 1, 0, 0])
    # the padded program equals the per-count one on its valid steps
    c_lat, _ = tpipe(None, ids, noise, num_inference_steps=3, deterministic_policy=True, decode=False)
    np.testing.assert_allclose(t_lat.numpy(), c_lat.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_plain_ddim_program_matches_jax(stacks, guidance):
    """factor_net=None is the degenerate DDIM solver; guidance <= 1 skips
    the uncond branch."""
    (unet, up, *_), (tunet, *_) = stacks
    rng = np.random.default_rng(12)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx, unc = (rng.standard_normal((2, 4, 32)).astype(np.float32) for _ in range(2))
    j_fn = jt2i.make_denoise_fn(lambda p, x, t, c: unet.apply(p, x, t, c),
                                schedules.DiffusionSchedule.sd15(), None, 3, guidance)
    t_fn = tt2i.make_denoise_fn(tunet, tschedules.DiffusionSchedule.sd15(), None, 3, guidance)
    j_lat, j_traj = j_fn(up, None, jax.random.key(0), noise, ctx, unc)
    with torch.no_grad():
        t_lat, t_traj = t_fn(None, *map(torch.from_numpy, (noise, ctx, unc)))
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), **TOL)
    _assert_traj(t_traj, j_traj, ("conds_x", "actions", "probs", "masks"))


def test_sampled_policy_runs_and_records():
    """Sampling draws from the given torch.Generator: the same seed gives the
    same rollout; the recorded probs are those of the drawn actions."""
    unet = TUNet(TUNetConfig.tiny(), device="cpu")
    te, vae = TClip(TClipConfig.tiny(), device="cpu"), TVae(TVaeConfig.tiny(), device="cpu")
    _, _, tnet = _factor(dict(order_dim=4, scaler_dim=0, num_actions=11), 3)
    pipe = tt2i.TextToImagePipeline(unet, te, vae, tschedules.DiffusionSchedule.sd15(),
                                    factor_net=tnet, device="cpu")
    ids, noise = _inputs()
    a_lat, a = pipe(torch.Generator().manual_seed(1), ids, noise, num_inference_steps=4, decode=False)
    b_lat, b = pipe(torch.Generator().manual_seed(1), ids, noise, num_inference_steps=4, decode=False)
    assert torch.equal(a_lat, b_lat) and torch.equal(a.actions, b.actions)
    assert a.actions.shape == (2, 3, 3) and torch.isfinite(a_lat).all()
    conds = {"x": a.conds_x[:, 0]}
    got, _ = tnet.get_action_probs(conds, a.actions[:, 0])
    np.testing.assert_allclose(a.probs[:, 0].numpy(), got.detach().numpy(), rtol=1e-6)


def test_unported_paths_raise(stacks):
    """The zoo serves its own names and refuses others
    (``tests/test_torch_solver_zoo.py`` holds the zoo); int8 serving is
    ported (``tests/test_torch_quant.py``) and its copy refuses them too."""
    _, tpipe = _pipelines(stacks, dict(order_dim=2, scaler_dim=0, num_actions=11))
    ids, noise = _inputs()
    for pipe in (tpipe, tpipe.quantize()):
        with pytest.raises(ValueError, match="Unknown solver"):
            pipe(None, ids, noise, num_inference_steps=2, solver="dpmsolver++")
