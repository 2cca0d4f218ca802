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
the one-ulp limit.  The plain versions are held at ``block_k = 1024`` too,
which the tensor-core route takes; the route, staging and ``block_k``
choices of the wrappers are plain functions tested here.  The int8 operands
must be bit-equal to what XLA compiles the JAX wrapper's quantization into
(it turns each division by 127 into a multiply by the f32 reciprocal, and
the port does the same);
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


@pytest.mark.parametrize("name,s", [("bf16", 1100), ("nomask", 2048)])
def test_plain_matches_pallas_at_block_k_1024(name, s):
    """The tensor-core route takes block_k past 512; its spec at 1024 (two
    chunks, the second ragged for bf16) still matches the Pallas kernel."""
    q, k, v = _qkv(1, s, 2, 128, seed=s)
    pallas = flash_bf16 if name == "bf16" else flash_nomask
    ref = pallas(q, k, v, block_q=256 if name == "nomask" else 128, block_k=1024, interpret=True)
    port = getattr(fv, f"flash_{name}")
    out = port(*map(_to_torch, (q, k, v)), block_q=256 if name == "nomask" else 128, block_k=1024)
    worst, past_ulp = _over_limit(out, ref, _flip_atol(q, k, v, int8=False))
    assert worst <= 1.0 and past_ulp <= 1e-3, (worst, past_ulp)


@pytest.mark.parametrize("dtype,variant,route", [
    (torch.bfloat16, "bf16", "mma"), (torch.bfloat16, "nomask", "mma"),
    (torch.float32, "bf16", "fma"), (torch.float16, "nomask", "fma"),
    (torch.bfloat16, "int8", "dp4a"), (torch.float32, "int8", "dp4a"),
])
def test_route_follows_dtype(dtype, variant, route):
    """bf16 q/k/v take the tensor cores; f32 / f16 stay on FMAs, which a
    bf16 MMA would round; int8 is its own kernel."""
    assert fv.kernel_route(dtype, variant) == route


@pytest.mark.parametrize("route,d,aligned,want", [
    ("mma", 128, True, "cp.async"), ("mma", 80, True, "cp.async"), ("mma", 72, True, "cp.async"),
    ("mma", 76, True, "elementwise"), ("mma", 128, False, "elementwise"),
    ("fma", 128, True, "elementwise"), ("dp4a", 128, True, "elementwise"),
])
def test_staging_follows_route_d_and_alignment(route, d, aligned, want):
    assert fv.staging(route, d, aligned) == want


def test_rows_aligned_reads_pointers_and_strides():
    packed = torch.zeros((2, 64, 3, 4, 128 + 8), dtype=torch.bfloat16)
    q, k, v = packed[..., :128].unbind(dim=2)  # row starts on 16 bytes
    assert fv.rows_aligned(q, k, v)
    flat = torch.zeros(2 * 64 * 4 * 128 + 1, dtype=torch.bfloat16)
    assert not fv.rows_aligned(flat[1:].view(2, 64, 4, 128))  # starts 2 bytes in
    assert not fv.rows_aligned(torch.zeros((1, 64, 2, 76), dtype=torch.bfloat16))  # 152-byte rows


@pytest.mark.parametrize("dtype,route,block_k,accepted", [
    (torch.bfloat16, None, 1024, True), (torch.bfloat16, None, 4096, True),
    (torch.bfloat16, "mma", 576, True), (torch.float32, None, 1024, False),
    (torch.float16, None, 576, False), (torch.bfloat16, "dp4a", 1024, False),
    (torch.bfloat16, "dp4a", 512, True),
])
def test_block_k_past_512_only_on_the_tensor_core_route(dtype, route, block_k, accepted):
    """The tensor-core kernel keeps no chunk in shared memory, so any
    multiple of 64 goes; the FMA and int8 kernels keep theirs to 512."""
    q = torch.zeros((1, 64, 2, 128), dtype=dtype)
    if accepted:
        fv._check(q, q, q, block_k, route)
    else:
        with pytest.raises(ValueError, match="up to 512"):
            fv._check(q, q, q, block_k, route)


def test_mma_ablations_apply_to_the_current_source(monkeypatch):
    """Every ablation of the tensor-core kernel is a set of literal edits
    that must each apply once to the source as it stands; the probe needs a
    card."""
    from consolver_torch.probes import mma_ablation

    sources = mma_ablation.altered_sources()
    assert set(sources) == {"kernel", *mma_ablation.ABLATIONS}
    assert len({sources[name] for name in sources}) == len(sources)
    assert {kind for kind, _ in mma_ablation.ABLATIONS.values()} == {"design", "cost", "mutant"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mma_ablation.run()


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
