"""consolver_torch.kernels (attention dispatch + flash attention's plain
version) against the JAX package's xla_attention and its Pallas kernel run
in interpret mode.

Tolerance: f32 softmax attention on the CPU, 1e-5 against XLA attention;
2e-5 against the Pallas kernel, whose online softmax rescales its running
sums once per 128-key block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.kernels import flash_attention as tfa
from consolver_torch.kernels.attention import attention, xla_attention
from consolver_tpu.kernels.attention import xla_attention as j_xla_attention
from tests.test_flash_attention import _flash_interpret

CASES = [  # (batch, sq, sk, heads, head_dim)
    (2, 64, 64, 2, 40),
    (2, 128, 77, 2, 40),
    (1, 256, 256, 2, 80),
    (2, 64, 77, 2, 160),
    (1, 256, 384, 2, 160),
    (1, 200, 200, 1, 512),
    (1, 256, 77, 1, 512),
]


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES)
def test_flash_plain_version_matches_jax(case):
    q, k, v = _qkv(*case)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = np.asarray(j_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(_flash_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


def test_large_scores_stay_finite():
    q = np.full((1, 128, 1, 128), 10.0, np.float32)
    v = np.random.default_rng(1).standard_normal((1, 128, 1, 128)).astype(np.float32)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(v)).numpy()
    assert np.isfinite(out).all()
    pallas = np.asarray(_flash_interpret(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v)))
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("is_causal", [False, True])
def test_xla_attention_matches_jax(is_causal):
    """The CLIP path: causal self-attention over 77 tokens."""
    q, k, v = _qkv(2, 77, 77, 2, 16, seed=2)
    out = xla_attention(*map(torch.from_numpy, (q, k, v)), is_causal=is_causal).numpy()
    ref = np.asarray(j_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=is_causal))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_xla_attention_mask_matches_jax():
    q, k, v = _qkv(2, 33, 47, 2, 8, seed=3)
    mask = np.random.default_rng(4).random((2, 1, 33, 47)) > 0.3
    mask[..., 0] = True
    out = xla_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask)).numpy()
    ref = np.asarray(j_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_dispatch_on_cpu():
    """Unmasked non-causal -> the flash plain version; causal or masked ->
    xla_attention.  No kernel launches on the CPU."""
    q, k, v = map(torch.from_numpy, _qkv(1, 32, 32, 2, 8, seed=5))
    before = tfa.flash_attention.launches
    assert torch.equal(attention(q, k, v), tfa.flash_attention_reference(q, k, v))
    assert torch.equal(attention(q, k, v, is_causal=True), xla_attention(q, k, v, is_causal=True))
    mask = torch.ones(1, 1, 32, 32, dtype=torch.bool).tril()
    assert torch.equal(attention(q, k, v, mask=mask), xla_attention(q, k, v, mask=mask))
    assert tfa.flash_attention.launches == before


def test_plain_version_keeps_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 16, 24, 2, 40, seed=6))
    out = tfa.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = tfa.flash_attention_reference(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)


@pytest.mark.parametrize(
    "shapes,dtype,error",
    [
        (((1, 8, 1, 640), (1, 8, 1, 640)), torch.float32, ValueError),  # head dim > 512
        (((1, 8, 2, 40), (1, 8, 2, 40)), torch.float64, TypeError),
        (((1, 8, 2, 40), (1, 8, 3, 40)), torch.float32, ValueError),
    ],
)
def test_kernel_shape_checks_raise(shapes, dtype, error):
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises(error):
        tfa.check_qkv(q, k, k)


def test_non_cuda_non_cpu_device_raises():
    q = torch.empty((1, 8, 2, 40), device="meta")
    with pytest.raises(RuntimeError):
        tfa.flash_attention(q, q, q)
