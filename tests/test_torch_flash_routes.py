"""Kernel #1's routes and the arithmetic of its tensor-core route, on the CPU.

The route and width choices are plain functions of
:mod:`consolver_torch.kernels.flash_attention`; the kernels themselves run
only on the card (``tests/test_torch_cuda.py``).

The tensor-core route keeps the Pallas kernel's function, f32 ``p``, by
splitting ``p`` into ``p_hi = bf16(p)`` and ``p_lo = bf16(p - p_hi)`` for the
``p v`` MMAs.  :func:`_emulate_mma` repeats that arithmetic in torch: exact
products of bf16 q and k summed in f32, the f32 scale by ``(1/sqrt(d))
log2(e)``, ``exp2``, an online softmax per key tile of the design (64 keys
in A, 32 in B), ``l`` over the f32 ``p`` and ``acc += p_hi v + p_lo v``,
rounded once to bf16.  It is held to the kernel's gate on the card,
``|out - ref| <= 2^-7 |ref| + 1e-5`` at every element (one bf16 ulp),
against the JAX Pallas kernel run in interpret mode on the same
bf16-valued inputs in f32.  With ``p`` as one bf16 value it fails that
gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.kernels import flash_attention as tfa
from tests.test_flash_attention import _flash_interpret
from tests.test_torch_attention import CASES

RTOL, ATOL = 2.0**-7, 1e-5
LOG2E = 1.4426950408889634
KEY_TILES = {"A": 64, "B": 32}  # keys per tile of each tensor-core design


def test_widths_and_designs_for_every_head_dim():
    """Every d in 1..512 has a route on both dtypes' kernels: the
    tensor-core width is the next multiple of 16 up to 160 (design A), then
    256 or 512 (design B); the FMA width the next of its eight."""
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        mma, fma = tfa.padded_width(d, "mma"), tfa.padded_width(d, "fma")
        if d <= 160:
            assert mma == -(-d // 16) * 16 and tfa.mma_design(d) == "A"
        else:
            assert mma == (256 if d <= 256 else 512) and tfa.mma_design(d) == "B"
        assert fma >= d and all(w < d for w in tfa.FMA_WIDTHS if w < fma)
    assert [tfa.padded_width(d, "mma") for d in (40, 80, 128, 160, 512)] == [48, 80, 128, 160, 512]
    for d in (0, 513):
        with pytest.raises(ValueError, match="head dims"):
            tfa.padded_width(d, "mma")


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "mma"), (torch.float32, "fma"), (torch.float16, "fma"),
])
def test_route_follows_dtype(dtype, route):
    assert tfa.kernel_route(dtype) == route


@pytest.mark.parametrize("route,d,aligned,want", [
    ("mma", 40, True, "cp.async"), ("mma", 512, True, "cp.async"), ("mma", 20, True, "elementwise"),
    ("mma", 128, False, "elementwise"), ("fma", 128, True, "elementwise"),
])
def test_staging_follows_route_d_and_alignment(route, d, aligned, want):
    assert tfa.staging(route, d, aligned) == want


def test_bf16_call_on_another_device_raises():
    """A bf16 tensor on neither cuda nor the CPU raises before any launch
    or build."""
    q = torch.empty((1, 8, 2, 40), device="meta", dtype=torch.bfloat16)
    before = dict(tfa.flash_attention.launches_by_route)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tfa.flash_attention(q, q, q)
    assert tfa.flash_attention.launches_by_route == before and tfa._library is None


def test_reset_counts_zeroes_every_route():
    tfa.flash_attention.launches_by_route["mma"] += 3
    tfa.flash_attention.launches += 3
    tfa.reset_counts()
    assert tfa.flash_attention.launches == 0
    assert tfa.flash_attention.launches_by_route == {"mma": 0, "fma": 0}


def _emulate_mma(q, k, v, split=True):
    """The tensor-core route's arithmetic on bf16 ``[B, S, H, D]`` q/k/v;
    ``split=False`` takes ``p`` as one bf16 value."""
    d = q.shape[-1]
    tile = KEY_TILES[tfa.mma_design(d)]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    # the wrapper passes 1/sqrt(d) as a C float; the kernel multiplies by
    # log2(e) in f32
    scale_log2 = float(np.float32(np.float32(1.0 / d**0.5) * np.float32(LOG2E)))
    m = torch.full(qf.shape[:3], -1e30)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, kf.shape[2], tile):
        x = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale_log2
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + tile]
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)


def _over_gate(case, split, seed=0):
    """The emulation's worst element over the one-ulp gate, against the
    Pallas kernel in interpret mode."""
    b, sq, sk, h, d = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
               .to(torch.bfloat16) for s in (sq, sk, sk))
    ref = np.asarray(_flash_interpret(*(jnp.asarray(x.float().numpy()) for x in (q, k, v))))
    out = _emulate_mma(q, k, v, split=split).float().numpy()
    return float((np.abs(out - ref) / (RTOL * np.abs(ref) + ATOL)).max())


@pytest.mark.parametrize("case", CASES)
def test_split_p_arithmetic_within_one_ulp_of_pallas(case):
    assert _over_gate(case, split=True) <= 1.0


def test_single_bf16_p_fails_the_gate():
    """The design decision: ``p`` rounded once to bf16 misses the one-ulp
    gate by far at the SD-1.5 cross-attention shape (77 keys)."""
    assert _over_gate(CASES[1], split=False) > 10.0


def test_kernel1_ablations_apply_to_the_current_source(monkeypatch):
    """Every ablation of kernel #1's tensor-core kernels is a set of literal
    edits that must each apply once to the source as it stands; the probe
    needs a card."""
    from consolver_torch.probes import mma_ablation

    sources = mma_ablation.altered_sources("kernel1")
    assert set(sources) == {"kernel", *mma_ablation.KERNEL1_ABLATIONS}
    assert len(set(sources.values())) == len(sources)
    kinds = {kind for kind, _ in mma_ablation.KERNEL1_ABLATIONS.values()}
    assert kinds == {"design", "cost", "mutant"}
    assert "plo, bv" not in sources["no_p_lo"].split("flash_fwd_mma_b_kernel")[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mma_ablation.run(target="kernel1")
