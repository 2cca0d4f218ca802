"""consolver_torch's PreviewSession against the JAX package's on the tiny
stack of ``tests/test_torch_pipeline.py``.

The previews take the plain-DDIM program (no policy, so nothing is sampled)
on the JAX session's own noise, fed to the port; the refine runs the
multistep-DPM teacher from a preview's noise on both sides.  Tolerance: the
slice's 2e-4 (f32 on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.core import schedules as tschedules
from consolver_torch.pipelines import preview as tpreview
from consolver_torch.pipelines import t2i as tt2i
from consolver_tpu.core import schedules
from consolver_tpu.pipelines import preview as jpreview
from consolver_tpu.pipelines import t2i as jt2i
from tests.test_torch_pipeline import TOL, _inputs, _pipelines, stacks  # noqa: F401

SESSION = dict(preview_steps=3, refine_steps=5)


@pytest.fixture(scope="module")
def sessions(stacks):  # noqa: F811
    (unet, up, te, tp, vae, vp), (tunet, tte, tvae) = stacks
    jpipe = jt2i.TextToImagePipeline(unet, up, te, tp, vae, vp,
                                     schedules.DiffusionSchedule.sd15())
    tpipe = tt2i.TextToImagePipeline(tunet, tte, tvae, tschedules.DiffusionSchedule.sd15(),
                                     device="cpu")
    return (jpreview.PreviewSession(jpipe, **SESSION),
            tpreview.PreviewSession(tpipe, **SESSION))


def test_defaults_match_jax(stacks):  # noqa: F811
    _, tpipe = _pipelines(stacks, dict(order_dim=2, scaler_dim=0, num_actions=11))
    t = tpreview.PreviewSession(tpipe)
    assert (t.preview_steps, t.refine_steps, t.guidance_scale) == (8, 40, 3.0)
    j = jpreview.PreviewSession.__init__.__defaults__
    assert j == (8, 40, "multistep-dpm", 3.0)
    assert tpreview.PreviewSession.__init__.__defaults__ == j


def test_preview_and_refine_match_jax(sessions):
    jsess, tsess = sessions
    ids, _ = _inputs(batch=1)
    key = jax.random.key(3)
    j_prev = jsess.preview(key, jnp.asarray(ids[0]), latent_hw=(8, 8), num_candidates=3)
    knoise, _ = jax.random.split(key)
    noise = np.array(jax.random.normal(knoise, (3, 8, 8, 4)))
    t_prev = tsess.preview(None, ids[0], latent_hw=(8, 8), num_candidates=3,
                           noise=torch.from_numpy(noise))
    assert len(t_prev) == 3 and t_prev[0].num_steps == 3
    for jp, tp in zip(j_prev, t_prev):
        np.testing.assert_array_equal(tp.noise.numpy(), np.asarray(jp.noise))
        assert tp.image.shape == (16, 16, 3)
        np.testing.assert_allclose(tp.image.numpy(), np.asarray(jp.image), **TOL)
    j_ref = jsess.refine(j_prev[1])
    t_ref = tsess.refine(t_prev[1])
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), **TOL)
    assert not np.allclose(t_ref.numpy(), t_prev[1].image.numpy(), atol=1e-3)


def test_refine_twice_is_bit_equal_and_previews_follow_the_generator(stacks):  # noqa: F811
    _, tpipe = _pipelines(stacks, dict(order_dim=2, scaler_dim=0, num_actions=11))
    sess = tpreview.PreviewSession(tpipe, **SESSION)
    ids, _ = _inputs(batch=1)

    def previews(seed):
        return sess.preview(torch.Generator().manual_seed(seed), ids[0], latent_hw=(8, 8),
                            num_candidates=2)

    a, b, a2 = previews(1), previews(2), previews(1)
    assert torch.equal(a[0].noise, a2[0].noise) and torch.equal(a[1].image, a2[1].image)
    assert not torch.equal(a[0].noise, b[0].noise)
    assert not torch.equal(a[0].noise, a[1].noise)  # candidates get their own noise
    assert torch.equal(sess.refine(a[0]), sess.refine(a[0]))
