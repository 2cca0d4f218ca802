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
The int8 kernel's walk (64-key tiles, two passes per chunk, the permuted K
rows whose scores land in the ``pq . v`` A fragment in natural key order,
int32 ``pq . v`` on the transposed V) is emulated in integers here and must
give the plain version's bits.
"""

import re


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
    (torch.bfloat16, "int8", "imma"), (torch.float32, "int8", "imma"),
])
def test_route_follows_dtype(dtype, variant, route):
    """bf16 q/k/v take the tensor cores; f32 / f16 stay on FMAs, which a
    bf16 MMA would round; int8 takes the int8 tensor cores for every output
    type."""
    assert fv.kernel_route(dtype, variant) == route


@pytest.mark.parametrize("route,d,aligned,want", [
    ("mma", 128, True, "cp.async"), ("mma", 80, True, "cp.async"), ("mma", 72, True, "cp.async"),
    ("mma", 76, True, "elementwise"), ("mma", 128, False, "elementwise"),
    ("fma", 128, True, "elementwise"), ("imma", 128, True, "cp.async"),
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
    (torch.float16, None, 576, False), (torch.bfloat16, "imma", 1024, True),
    (torch.bfloat16, "imma", 1088, False),
])
def test_block_k_past_512_only_on_the_tensor_core_route(dtype, route, block_k, accepted):
    """The tensor-core kernels keep no chunk in shared memory: "mma" takes
    any multiple of 64, "imma" any up to 1024 (where ``pq . v`` stays exact
    in f32); the FMA kernel keeps its chunk to 512."""
    q = torch.zeros((1, 64, 2, 128), dtype=dtype)
    if accepted:
        fv._check(q, q, q, block_k, route)
    else:
        limit = 1024 if route == "imma" else 512
        with pytest.raises(ValueError, match=f"up to {limit}"):
            fv._check(q, q, q, block_k, route)


def test_mma_ablations_apply_to_the_current_source(monkeypatch):
    """Every ablation of the tensor-core kernel is a set of literal edits
    that must each apply once to the source as it stands; the probe needs a
    card."""
    from consolver_torch.probes import mma_ablation

    for target, ablations in (("variants", mma_ablation.ABLATIONS),
                              ("int8", mma_ablation.INT8_ABLATIONS)):
        sources = mma_ablation.altered_sources(target)
        assert set(sources) == {"kernel", *ablations}
        assert len({sources[name] for name in sources}) == len(sources)
        assert {kind for kind, _ in ablations.values()} == {"design", "cost", "mutant"}
    assert {"max_per_tile", "no_k_permutation"} <= set(mma_ablation.INT8_ABLATIONS)
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


# ---------------------------------------------------------------------------
# The int8 tensor-core kernel's walk, emulated in integers
# ---------------------------------------------------------------------------

_CU = fv._SOURCE.read_text()


def _c_function(name):
    """A one-line integer function of ``flash_variants.cu`` as a Python
    function: C and Python agree on ``* + >> & ^ |`` and their precedence."""
    found = re.search(rf"int {name}\(int (\w+), int (\w+)\) {{\n  return (.+);\n}}", _CU)
    a, b, body = found.groups()
    return eval(f"lambda {a}, {b}: {body}")  # noqa: S307 - the repository's own source


def _lane_key():
    """The K row a lane addresses in ``tile_scores_i8``'s ldmatrix, per
    16-key group (the permutation as the kernel applies it)."""
    body = _CU[_CU.index("void tile_scores_i8("):]
    expr = re.search(r"const int key = (.+);", body).group(1)
    return eval(f"lambda lane: {expr}")  # noqa: S307


SCORE_KEY = _c_function("score_key")
I8_CHUNK = _c_function("i8_chunk")


def _a_index(j, c):
    """Where the kernel's packing puts the score of n-tile j, column c
    (lane t = c // 2) in its pq . v A fragment: ``pf[j // 4]`` register
    ``2 ((j & 3) >> 1) + row``, byte ``2 (j & 1) + (c & 1)``, i.e. k index
    ``16 ((j & 3) >> 1) + 4 t + 2 (j & 1) + (c & 1)`` of its 32-key group."""
    return 32 * (j >> 2) + 16 * ((j & 3) >> 1) + 4 * (c >> 1) + 2 * (j & 1) + (c & 1)


def test_int8_score_permutation_is_a_bijection():
    """On each 32-key group the permutation maps the 4 n-tiles x 8 columns
    onto its 32 keys once each; the packing puts every score at its own key
    (natural order in the A fragment); and the ldmatrix lane addresses are
    that permutation."""
    for group in range(2):
        keys = [SCORE_KEY(j, c) for j in range(4 * group, 4 * group + 4) for c in range(8)]
        assert sorted(keys) == list(range(32 * group, 32 * group + 32))
    assert all(_a_index(j, c) == SCORE_KEY(j, c) for j in range(8) for c in range(8))
    lane_key = _lane_key()
    for lane in range(32):
        m, r = lane >> 3, lane & 7  # lane 8m + r addresses row r of matrix m
        for jp in range(4):
            assert 16 * jp + lane_key(lane) == SCORE_KEY(2 * jp + (m >> 1), r)
    assert [lane_key(l) for l in range(8)] != list(range(8))  # not the natural order


def test_int8_swizzle_spreads_every_ldmatrix_over_all_banks():
    """Each ldmatrix matrix reads 8 rows of 16 bytes; on 128-byte rows the
    swizzled chunks must fall on 8 distinct 16-byte bank groups, for the Q
    fragments (8 consecutive rows) and for the permuted K rows."""
    lane_key = _lane_key()
    for kk_half in range(8):
        for base in range(0, 64, 8):  # Q: rows base..base+7
            assert len({I8_CHUNK(base + r, kk_half) for r in range(8)}) == 8
        for jp in range(4):
            for m in range(4):  # K: the 8 lanes of matrix m
                rows = [16 * jp + lane_key(8 * m + r) for r in range(8)]
                assert len({I8_CHUNK(row, kk_half) for row in rows}) == 8
        assert sorted(I8_CHUNK(r, c) for r in (0,) for c in range(8)) == list(range(8))


@pytest.mark.parametrize("d,sk", [(128, 77), (72, 200), (80, 64)])
def test_int8_kernel_operands_lose_nothing(d, sk):
    """Un-padding and un-transposing the kernel's operands gives back
    quantize_int8's tensors; the padding is zeros and every row is a
    multiple of 16 bytes."""
    q, k, v = map(_to_torch, _qkv(2, sk, 3, d, seed=d + sk))
    qq, qs, kq, ks, vq, vs = fv.quantize_int8(q[:, :50], k, v)
    ops = fv.int8_kernel_operands(qq, qs, kq, ks, vq, vs)
    dpad, skpad = -(-d // 16) * 16, -(-sk // 16) * 16
    assert ops.qq.shape == (2, 50, 3, dpad) and ops.kq.shape == (2, sk, 3, dpad)
    assert ops.vq_t.shape == (2, 3, dpad, skpad) and ops.ks_t.shape == (2, 3, skpad)
    assert all(t.is_contiguous() for t in ops)
    assert torch.equal(ops.qq[..., :d], qq) and torch.equal(ops.kq[..., :d], kq)
    assert torch.equal(ops.vq_t[:, :, :d, :sk].permute(0, 3, 1, 2), vq)
    assert torch.equal(ops.ks_t[..., :sk].permute(0, 2, 1), ks)
    assert torch.equal(ops.qs, qs) and torch.equal(ops.vs, vs)
    for t, tail in ((ops.qq, ops.qq[..., d:]), (ops.kq, ops.kq[..., d:]),
                    (ops.vq_t, ops.vq_t[:, :, d:]), (ops.vq_t, ops.vq_t[..., sk:]),
                    (ops.ks_t, ops.ks_t[..., sk:])):
        assert not tail.any()


def _emulate_int8_kernel(q, k, v, block_k):
    """``int8_mma_kernel``'s walk in torch on the laid-out operands: per
    ``block_k`` chunk, 64-key tiles; each tile's integer scores with the K
    rows permuted (column 8j + c scores key ``score_key(j, c)``), scaled and
    masked as the kernel does; pass 1 keeps the running row max; pass 2
    recomputes the tiles, forms ``pq`` against the chunk's max, sums it in
    integers, packs each column at its A-fragment index and adds the int
    ``pq . v`` of the transposed V tile.  The f32 steps repeat the kernel's
    (and the plain version's) order; ``exp`` runs on the chunk in natural
    key order, the shape the plain version gives it, so that the CPU's
    vectorised exp sees the same elements."""
    ops = fv.int8_kernel_operands(*fv.quantize_int8(q, k, v))
    b, sq, h, _ = ops.qq.shape
    d, sk = q.shape[-1], k.shape[1]
    qi = ops.qq.permute(0, 2, 1, 3).long()
    ki = ops.kq.permute(0, 2, 1, 3).long()
    q_mul = ops.qs.permute(0, 2, 1) * (1.0 / d**0.5)
    col_key = torch.tensor([SCORE_KEY(j, c) for j in range(8) for c in range(8)])
    a_pos = torch.tensor([_a_index(j, c) for j in range(8) for c in range(8)])

    def tile_scores(t0):
        keys = t0 + col_key
        valid = keys < sk
        kt = ki[:, :, keys.clamp(max=sk - 1)] * valid[:, None]
        si = torch.einsum("bhqd,bhkd->bhqk", qi, kt)
        kscale = ops.ks_t[:, :, keys.clamp(max=ops.ks_t.shape[-1] - 1)]
        s = si.float() * q_mul[..., None] * kscale[:, :, None, :]
        return torch.where(valid, s, torch.tensor(fv.NEG_INF))

    m = torch.full((b, h, sq), fv.NEG_INF)
    l = torch.full((b, h, sq), 1e-20)
    acc = torch.zeros((b, h, sq, d))
    for c0 in range(0, sk, block_k):
        n = min(block_k, sk - c0)
        tiles = range(c0, c0 + n, 64)
        rmax = torch.full((b, h, sq), fv.NEG_INF)
        for t0 in tiles:  # pass 1
            rmax = torch.maximum(rmax, tile_scores(t0).amax(dim=-1))
        m_new = torch.maximum(m, rmax)
        alpha = torch.exp(m - m_new)
        s_nat = torch.empty((b, h, sq, len(tiles) * 64))
        for i, t0 in enumerate(tiles):  # pass 2: the same integers again
            s_nat[..., 64 * i + col_key] = tile_scores(t0)
        pq = fv.int8_chunk_probs(s_nat[..., :n].contiguous(), m_new)
        pq = torch.nn.functional.pad(pq, (0, s_nat.shape[-1] - n)).long()
        pv = torch.zeros((b, h, sq, ops.vq_t.shape[2]), dtype=torch.long)
        for i, t0 in enumerate(tiles):
            c_regs = pq[..., 64 * i + col_key]  # the C registers of the tile
            a_frag = torch.zeros_like(c_regs)
            a_frag[..., a_pos] = c_regs  # packed: natural key order
            vt = ops.vq_t[..., t0:t0 + 64].long()
            vt = torch.nn.functional.pad(vt, (0, 64 - vt.shape[-1]))
            pv += torch.einsum("bhqk,bhdk->bhqd", a_frag, vt)
        l = l * alpha + pq.sum(dim=-1).float() * fv.INV127
        acc = acc * alpha[..., None] + pv[..., :d].float() * ops.vs[:, :, None, :]
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("block_k", [64, 512, 1024])
@pytest.mark.parametrize("s", [77, 200])
def test_int8_kernel_walk_is_bit_equal_to_the_plain_version(s, block_k):
    """The emulated kernel walk gives flash_int8_reference's bits, and both
    lie within the int8 limits of the Pallas kernel in interpret mode."""
    q, k, v = _qkv(1, s, 2, 128, seed=s + block_k)
    tq, tk, tv = map(_to_torch, (q, k, v))
    emulated = _emulate_int8_kernel(tq, tk, tv, block_k)
    plain = fv.flash_int8_reference(tq, tk, tv, block_k=block_k)
    assert torch.equal(emulated, plain)
    ref = flash_int8(q, k, v, block_q=128, block_k=block_k, interpret=True)
    worst, past_ulp = _over_limit(emulated, ref, _flip_atol(q, k, v, int8=True))
    assert worst <= 1.0 and past_ulp <= 1e-3, (worst, past_ulp)


def test_int8_walk_without_the_k_permutation_fails():
    """The emulation with natural K rows (the ``no_k_permutation`` mutant's
    edit): the scores meet the wrong k scales and V rows, far past the
    limits."""
    global SCORE_KEY
    q, k, v = map(_to_torch, _qkv(1, 200, 2, 128, seed=40))
    plain = fv.flash_int8_reference(q, k, v, block_k=128)
    keep = SCORE_KEY
    try:
        SCORE_KEY = lambda j, c: 8 * j + c  # noqa: E731
        natural_rows = _emulate_int8_kernel(q, k, v, 128)
    finally:
        SCORE_KEY = keep
    assert (natural_rows.float() - plain.float()).abs().max().item() > 0.1

