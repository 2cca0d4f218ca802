"""The learning checks (``cli/learning_check.py``,
``cli/learning_check_edit.py``) against the JAX scripts
(``scripts/learning_check.py``, ``scripts/learning_check_edit.py``) on the
same tiny stacks, the port's weights carried into JAX by the JAX
converters (no JAX init to compile): the
teacher latents of both checks equal JAX's within 1e-5 of their largest
magnitude (the sums of 40 and 20 f32 solver steps), and three port PPO
steps of each (and of the int8 rollout) run finite.  The full 240- and
300-step runs of both packages take minutes on the CPU and are marked
``slow``; there the port's delta is held to > 0.05, as the JAX scripts'
verdict holds theirs.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.cli import learning_check as tcheck
from consolver_torch.cli import learning_check_edit as tcheck_edit
from consolver_torch.models import checkpoint as ck
from consolver_tpu.models import convert as jconv
from consolver_tpu.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_tpu.models.flux import FluxConfig, FluxTransformer
from consolver_tpu.models.t5 import T5Config, T5Encoder, convert_t5
from consolver_tpu.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_tpu.models.vae import AutoencoderKL, VaeConfig
from consolver_tpu.pipelines.edit import FluxKontextPipeline as JPipe

ROOT = Path(__file__).resolve().parent.parent
TEACHER_TOL = 1e-5  # of the largest |latent|: 40 / 20 f32 solver steps of either package


def _assert_teacher_close(got, want):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TEACHER_TOL * scale, (err, scale)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny stacks' ops are too small to split, and
    the suite's workers share the host's cores (with the default count the
    port's teacher runs tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tree(module, kind, convert):
    """The JAX converter's tree of the port module's weights (its hub state
    dict): both packages then hold the same weights."""
    return convert({k: v.numpy() for k, v in ck.hub_state_dict(module, kind).items()})


@pytest.fixture(scope="module")
def sd_stacks():
    """(JAX UNet, its params, JAX CLIP, its params), and the port's stack."""
    port = tcheck.tiny_stack("cpu")
    unet, text, _ = port
    return ((UNet2DCondition(UNetConfig.tiny()), _jax_tree(unet, "unet", jconv.convert_unet),
             ClipTextEncoder(ClipTextConfig.tiny()),
             _jax_tree(text, "clip_text", jconv.convert_clip_text)), port)


@pytest.fixture(scope="module")
def flux_stacks():
    """The JAX FLUX-Kontext pipeline over the port's tiny stack's weights,
    and the port's stack."""
    port = tcheck_edit.tiny_stack("cpu")
    transformer, t5, clip, vae = port
    fcfg = FluxConfig.tiny()
    jpipe = JPipe(
        FluxTransformer(fcfg), _jax_tree(transformer, "flux", jconv.convert_flux),
        T5Encoder(T5Config(vocab_size=64, d_model=fcfg.joint_text_dim, d_kv=8, d_ff=64,
                           num_layers=1, num_heads=4)), _jax_tree(t5, "t5", convert_t5),
        ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=fcfg.pooled_text_dim,
                                       num_layers=1, num_heads=2, intermediate_size=32)),
        _jax_tree(clip, "clip_text", jconv.convert_clip_text),
        AutoencoderKL(VaeConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                                latent_channels=4)), _jax_tree(vae, "vae", jconv.convert_vae))
    return jpipe, port


def test_sd_teacher_matches_jax(sd_stacks):
    """The JAX script's teacher: 40-step DDIM, the tokenized empty prompt
    as uncond, the same rng draws."""
    from consolver_tpu.core import schedules
    from consolver_tpu.data.tokenizer import HashTokenizer, uncond_input_ids
    from consolver_tpu.pipelines.t2i import make_denoise_fn

    (unet, up, te, tp), port = sd_stacks
    noises, prompt_ids, got = tcheck.teacher(port, "cpu", np.random.default_rng(0))
    rng = np.random.default_rng(0)
    jnoises = rng.standard_normal((8, 8, 8, 4)).astype(np.float32)
    jprompts = rng.integers(1, 900, (8, 4)).astype(np.int64)
    np.testing.assert_array_equal(noises, jnoises)
    np.testing.assert_array_equal(prompt_ids, jprompts)
    teacher = jax.jit(make_denoise_fn(lambda p, x, t, c: unet.apply(p, x, t, c),
                                      schedules.DiffusionSchedule.sd15(), None, 40, 3.0,
                                      record_trajectory=False))
    enc = jax.jit(lambda ids: te.apply(tp, ids))
    unc = enc(jnp.asarray(uncond_input_ids(HashTokenizer(max_length=4), 1, 4,
                                           vocab_size=te.cfg.vocab_size)))
    # two of the eight prompts in one call: the JAX teacher is the slow side
    # (each scan step's many small ops), and the script's rows are independent
    picked = [0, 5]
    want = teacher(up, None, jax.random.key(0), jnp.asarray(jnoises[picked]),
                   enc(jnp.asarray(jprompts[picked])), jnp.concatenate([unc, unc]))[0]
    _assert_teacher_close(got[picked], np.asarray(want))


def test_edit_teacher_matches_jax(flux_stacks):
    from consolver_torch.pipelines.edit import FluxKontextPipeline

    jpipe, port = flux_stacks
    tpipe = FluxKontextPipeline(*port, device="cpu")
    refs, noises, t5_ids, clip_ids, got = tcheck_edit.teacher(tpipe, np.random.default_rng(0))
    picked = [0, 3]  # two of the six pairs in one call: the JAX pipeline is the slow side
    want, _ = jpipe(jax.random.key(0), jnp.asarray(t5_ids[picked]), jnp.asarray(clip_ids[picked]),
                    jnp.asarray(refs[picked]), jnp.asarray(noises[picked]), num_inference_steps=20,
                    guidance_scale=2.5, solver="euler", decode=False)
    _assert_teacher_close(got[picked], np.asarray(want))


@pytest.mark.parametrize("check", ["sd", "sd_quantize", "edit"])
def test_three_port_steps_run_finite(sd_stacks, flux_stacks, check):
    lines = []
    if check == "edit":
        first, last, delta, rewards = tcheck_edit.run(flux_stacks[1], steps=3, device="cpu",
                                                      log=lines.append)
    else:
        first, last, delta, rewards = tcheck.run(sd_stacks[1], quantize=check == "sd_quantize",
                                                 steps=3, device="cpu", log=lines.append)
    assert len(rewards) == 3 and np.isfinite(rewards).all()
    assert np.isfinite([first, last, delta]).all()
    assert lines[0] == "teacher built" and lines[-1] in ("LEARNING", "NO-CLEAR-LEARNING")


def _jax_delta(script):
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / script)], cwd=ROOT,
                          capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return float(re.search(r"delta=([-+0-9.]+)", proc.stdout).group(1))


@pytest.mark.slow
@pytest.mark.parametrize("check", ["sd", "edit"])
def test_full_runs_learn_in_both_packages(check):
    """The full checks: 240 SD / 300 FLUX steps, the port's own stacks and
    the JAX scripts, each delta above the 0.05 margin."""
    if check == "sd":
        *_, delta, _ = tcheck.run(device="cpu")
        jax_delta = _jax_delta("learning_check.py")
    else:
        *_, delta, _ = tcheck_edit.run(device="cpu")
        jax_delta = _jax_delta("learning_check_edit.py")
    assert delta > tcheck.MARGIN and jax_delta > tcheck.MARGIN, (delta, jax_delta)
