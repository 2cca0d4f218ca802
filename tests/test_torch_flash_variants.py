"""The plain versions of the three flash-attention variants (kernels #2-#4)
against the JAX package's Pallas kernels in ``scripts/probe_flash_variants.py``
run in interpret mode on the CPU, on bf16 inputs made from a numpy seed at
``(1, 200|256, 2, 128)`` with 128-blocks.

Tolerances, per element, ``|out - ref| <= 2^-7 |ref| + 1e-5 + flip`` (one
bf16 ulp of the output, plus a rounding flip).  Both sides walk the same
chunks, but the scores' f32 sums run in another order and exp comes from
another library, so a ``p`` close to a rounding boundary can round the
other way.  With ``P`` the case's heaviest attention weight (``1 / l`` of
its row) and ``V = max|v|``:
  * flash_bf16 / flash_nomask: ``flip = 2^-7 P V``, one bf16 ulp of the
    heaviest ``p``;
  * flash_int8: ``flip = 2 P V / 127``: a ``round(p * 127)`` that flips
    moves its row by ``(v_j - out) / (127 l)``.
At these 200-256-key shapes ``P`` is 0.14-0.26; at the FLUX shapes (8704
keys) it is far smaller.  The tests also bound the share of elements past
the one-ulp limit.  The int8 operands must be bit-equal to what XLA
compiles the JAX wrapper's quantization into (it turns each division by
127 into a multiply by the f32 reciprocal, and the port does the same);
with them the int8 outputs here are bit-equal but for the rare exp flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.kernels import flash_variants as fv
from scripts.probe_flash_variants import flash_bf16, flash_int8, flash_nomask

RTOL = 2.0**-7
ATOL = 1e-5


def _qkv(b, s, h, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    shapes = ((b, s, h, d), (b, sk or s, h, d), (b, sk or s, h, d))
    return tuple(jnp.asarray(rng.standard_normal(shp).astype(np.float32), jnp.bfloat16)
                 for shp in shapes)


def _to_torch(x):
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)


def _flip_atol(q, k, v, int8):
    """The rounding-flip allowance: ``P`` is the largest softmax weight."""
    qf, kf = (np.asarray(x.astype(jnp.float32), np.float64).transpose(0, 2, 1, 3) for x in (q, k))
    s = np.einsum("bhqd,bhkd->bhqk", qf, kf) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    heaviest = float((1.0 / p.sum(axis=-1)).max())
    vmax = float(jnp.max(jnp.abs(v.astype(jnp.float32))))
    return ATOL + (2 * heaviest * vmax / 127 if int8 else RTOL * heaviest * vmax)


def _over_limit(out, ref, atol):
    """The worst element's error as a share of its limit, and the share of
    elements past the one-ulp limit."""
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out - ref)
    return float((err / (RTOL * np.abs(ref) + atol)).max()), float(
        (err > RTOL * np.abs(ref) + ATOL).mean())


@pytest.mark.parametrize("s", [200, 256])
@pytest.mark.parametrize("block_k", [128, 256])
def test_bf16_plain_matches_pallas(s, block_k):
    q, k, v = _qkv(1, s, 2, 128, seed=s + block_k)
    ref = flash_bf16(q, k, v, block_q=128, block_k=block_k, interpret=True)
    out = fv.flash_bf16(*map(_to_torch, (q, k, v)), block_q=128, block_k=block_k)
    assert out.dtype == torch.bfloat16 and out.shape == (1, s, 2, 128)
    worst, past_ulp = _over_limit(out, ref, _flip_atol(q, k, v, int8=False))
    assert worst <= 1.0 and past_ulp <= 1e-3, (worst, past_ulp)


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (256, 128), (128, 256)])
def test_nomask_plain_matches_pallas(block_q, block_k):
    q, k, v = _qkv(1, 256, 2, 128, seed=3)
    ref = flash_nomask(q, k, v, block_q=block_q, block_k=block_k, interpret=True)
    out = fv.flash_nomask(*map(_to_torch, (q, k, v)), block_q=block_q, block_k=block_k)
    worst, past_ulp = _over_limit(out, ref, _flip_atol(q, k, v, int8=False))
    assert worst <= 1.0 and past_ulp <= 1e-3, (worst, past_ulp)


def test_nomask_rejects_ragged_blocks():
    q = torch.zeros((1, 200, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        fv.flash_nomask(q, q, q, block_q=128, block_k=128)


def _jax_quantize(q, k, v):
    """The quantization inside the JAX ``flash_int8`` wrapper
    (scripts/probe_flash_variants.py:153-171), written out with jnp."""

    def quant_tokens(x):
        x32 = x.astype(jnp.float32)
        s = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True), 1e-8) / 127.0
        return jnp.clip(jnp.round(x32 / s), -127, 127).astype(jnp.int8), s

    qq, qs = quant_tokens(q)
    kq, ks = quant_tokens(k)
    v32 = v.astype(jnp.float32)
    v_scale = jnp.maximum(jnp.max(jnp.abs(v32), axis=1, keepdims=True), 1e-8) / 127.0
    vq = jnp.clip(jnp.round(v32 / v_scale), -127, 127).astype(jnp.int8)
    return qq, qs[..., 0], kq, ks[..., 0], vq, (v_scale / 127.0)[:, 0]


@pytest.mark.parametrize("seed", [5, 6])
def test_int8_operands_bit_equal(seed):
    """Against the JAX wrapper's expressions compiled by XLA, as the jitted
    ``flash_int8`` compiles them (divisions by 127 become multiplies)."""
    q, k, v = _qkv(2, 200, 2, 128, seed=seed)
    for t, j in zip(fv.quantize_int8(*map(_to_torch, (q, k, v))), jax.jit(_jax_quantize)(q, k, v)):
        assert t.dtype == (torch.int8 if j.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _int8_case(s, block_k, seed):
    q, k, v = _qkv(1, s, 2, 128, seed=seed)
    ref = flash_int8(q, k, v, block_q=128, block_k=block_k, interpret=True)
    out = fv.flash_int8(*map(_to_torch, (q, k, v)), block_q=128, block_k=block_k)
    return out, ref, _flip_atol(q, k, v, int8=True)


@pytest.mark.parametrize("s", [200, 256])
def test_int8_plain_matches_pallas(s):
    out, ref, atol = _int8_case(s, 128, seed=s)
    assert out.dtype == torch.bfloat16
    worst, past_ulp = _over_limit(out, ref, atol)
    assert worst <= 1.0 and past_ulp <= 1e-3, (worst, past_ulp)


def test_int8_depends_on_block_k():
    """At 128 and 256 keys per chunk, each plain version matches its Pallas
    run (at most 0.1 % of elements past one ulp) while the two chunkings
    differ from each other past one ulp at over 20 % of the elements:
    ``round(p * 127)`` is taken against each chunk's own max."""
    q, k, v = _qkv(1, 256, 2, 128, seed=11)
    tq, tk, tv = map(_to_torch, (q, k, v))
    atol = _flip_atol(q, k, v, int8=True)
    outs = {}
    for block_k in (128, 256):
        ref = flash_int8(q, k, v, block_q=128, block_k=block_k, interpret=True)
        outs[block_k] = fv.flash_int8(tq, tk, tv, block_q=128, block_k=block_k)
        worst, past_ulp = _over_limit(outs[block_k], ref, atol)
        assert worst <= 1.0 and past_ulp <= 1e-3, (block_k, worst, past_ulp)
    a, b = outs[128].float(), outs[256].float()
    between = ((a - b).abs() > RTOL * b.abs() + ATOL).float().mean().item()
    assert between > 0.2, between


def test_int8_probability_flips_are_rare():
    """``round(p * 127)`` on the same f32 scores with torch's and XLA's exp:
    the two exps differ by an ulp now and then, which flips a value sitting
    on a .5 boundary.  Counted over the first 512-key chunk of a
    (1, 1024, 4, 128) case: 4.2 M (row, key) pairs."""
    q, k, v = _qkv(1, 1024, 4, 128, seed=21)
    qq, qs, kq, ks, _, _ = jax.jit(_jax_quantize)(q, k, v)
    s = jnp.einsum("bqhd,bkhd->bhqk", qq.astype(jnp.int32), kq[:, :512].astype(jnp.int32))
    s = (s.astype(jnp.float32) * (qs.transpose(0, 2, 1)[..., None] / np.sqrt(128.0))
         * ks[:, :512].transpose(0, 2, 1)[:, :, None, :])
    m = s.max(axis=-1)
    j_pq = np.asarray(jnp.round(jnp.exp(s - m[..., None]) * 127.0))
    t_pq = fv.int8_chunk_probs(torch.from_numpy(np.asarray(s)), torch.from_numpy(np.asarray(m)))
    flips = int((t_pq.numpy() != j_pq).sum())
    assert flips <= 1e-5 * j_pq.size, flips


def test_int8_probs_round_half_to_even():
    scores = torch.log(torch.tensor([[0.5 / 127, 1.5 / 127, 2.5 / 127, 1.0]], dtype=torch.float64))
    pq = fv.int8_chunk_probs(scores.float(), torch.zeros(1))
    assert pq.tolist()[0][3] == 127.0 and pq.tolist()[0][0] in (0.0, 1.0)


def test_wrappers_reject_what_the_kernels_cannot_take():
    q = torch.zeros((1, 64, 2, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fv._check(q, q, q, 512)
    q = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_k"):
        fv._check(q, q, q, 96)
    with pytest.raises(TypeError):
        fv._check(q.double(), q.double(), q.double(), 128)
    with pytest.raises(ValueError, match="1024"):
        fv.flash_int8(q, q, q, block_k=2048)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        fv.flash_bf16(*(torch.empty((1, 64, 2, 128), device="meta"),) * 3)


def test_cpu_path_launches_nothing():
    q, k, v = map(_to_torch, _qkv(1, 64, 2, 128, seed=2))
    before = [f.launches for f in fv.KERNELS]
    for f in fv.KERNELS:
        f(q, k, v, block_q=64, block_k=64)
    assert [f.launches for f in fv.KERNELS] == before and fv._library is None


def test_probe_entry_point_runs_on_the_cpu(monkeypatch):
    """The probe's three parts at its tiny shapes with the plain versions;
    the sweep keeps only the block pairs that divide the serving length."""
    from consolver_torch.probes import flash_variants as probe

    lines = []
    result = probe.run("cpu", probe.TINY_SHAPES, iters=1, log=lines.append)
    assert result["device"] == "cpu" and set(result["accuracy"]) == {"bf16dot", "int8"}
    assert result["accuracy"]["bf16dot"] < 1e-2 and result["accuracy"]["int8"] < 5e-2
    assert len(result["timing"]) == 2 * len(probe.VARIANTS)
    assert set(result["nomask_sweep"]) == {"bq512/bk512", "bq256/bk512"}
    assert len(lines) == 2 + len(result["timing"]) + 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):  # no card: it points at --device cpu --tiny
        probe.main([])
