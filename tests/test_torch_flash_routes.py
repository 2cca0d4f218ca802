"""Kernel #1's routes and the arithmetic of its tensor-core route, on the CPU.

The route and width choices are plain functions of
:mod:`consolver_torch.kernels.flash_attention`; the kernels themselves run
only on the card (``tests/test_torch_cuda.py``).

The tensor-core route keeps the Pallas kernel's function, f32 ``p``, by
splitting ``p`` into ``p_hi = bf16(p)`` and ``p_lo = bf16(p - p_hi)`` for the
``p v`` MMAs.  :func:`_emulate_mma` repeats that arithmetic in torch: exact
products of bf16 q and k summed in f32, the f32 scale by ``(1/sqrt(d))
log2(e)``, ``exp2``, an online softmax per key tile of the design (64 keys
in A, 32 in B, 128 in H, whose exponent is one fused multiply-add of the
raw score), ``l`` over the f32 ``p`` and ``acc += p_hi v + p_lo v``,
rounded once to bf16.  It is held to the kernel's gate on the card,
``|out - ref| <= 2^-7 |ref| + 1e-5`` at every element (one bf16 ulp),
against the JAX Pallas kernel run in interpret mode on the same
bf16-valued inputs in f32.  With ``p`` as one bf16 value it fails that
gate.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.kernels import flash_attention as tfa
from tests.test_flash_attention import _flash_interpret
from tests.test_torch_attention import CASES

RTOL, ATOL = 2.0**-7, 1e-5
LOG2E = 1.4426950408889634
KEY_TILES = {"A": 64, "B": 32, "H": 128}  # keys per tile of each tensor-core design
# widths design H takes, beside CASES (whose widths 48 / 80 / 160 / 512 it does not)
H_CASES = [(2, 300, 333, 2, 64), (1, 200, 129, 2, 128)]


def test_widths_and_designs_for_every_head_dim():
    """Every d in 1..512 has a route on both dtypes' kernels: the
    tensor-core width is the next multiple of 16 up to 160, then 256 or 512;
    the design is H when the rows arrive by copies (``d % 8 == 0`` and
    aligned) at widths 64, 80 and 128 and, past one 128-key tile, 48; A at
    the other widths up to 160 and for rows staged element by element; B
    above; the query length never moves it.  The FMA width is the next of
    its eight."""
    lengths = [(1, 1), (130, 77), (100, 128), (300, 129), (4429, 4429), (8320, 8320),
               (16384, 256)]
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        mma, fma = tfa.padded_width(d, "mma"), tfa.padded_width(d, "fma")
        for aligned in (True, False):
            for sq, sk in lengths:
                if d <= 160:
                    assert mma == -(-d // 16) * 16
                    copies = aligned and d % 8 == 0
                    h = mma in (64, 80, 128) or (mma == 48 and sk > 128)
                    want = "H" if copies and h else "A"
                else:
                    assert mma == (256 if d <= 256 else 512)
                    want = "B"
                assert tfa.mma_design(d, aligned, sq, sk) == want
                assert tfa.mma_design(d, aligned, 1, sk) == want
        assert tfa.mma_design(d) == tfa.mma_design(d, True, 1, 1)
        assert fma >= d and all(w < d for w in tfa.FMA_WIDTHS if w < fma)
    assert [tfa.padded_width(d, "mma") for d in (40, 80, 128, 160, 512)] == [48, 80, 128, 160, 512]
    assert [tfa.mma_design(d, True, 4096, 4096) for d in (40, 56, 64, 80, 120, 128, 160, 512)] == [
        "H", "H", "H", "H", "H", "H", "A", "B"]
    assert [tfa.mma_design(40, True, 4096, sk) for sk in (77, 128, 129)] == ["A", "A", "H"]
    assert [tfa.mma_design(d, False, 4096, 4096) for d in (40, 64, 80, 128)] == ["A"] * 4
    assert [tfa.mma_design(d) for d in (60, 124)] == ["A", "A"]  # d % 8 != 0: element staging
    for d in (0, 513):
        with pytest.raises(ValueError, match="head dims"):
            tfa.padded_width(d, "mma")
        with pytest.raises(ValueError, match="head dims"):
            tfa.mma_design(d)
    with pytest.raises(ValueError, match="lengths"):
        tfa.mma_design(64, True, 0, 77)


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


def test_reset_counts_zeroes_launches_by_design():
    for design, n in (("A", 2), ("B", 1), ("H", 5)):
        tfa.flash_attention.launches_by_design[design] += n
    tfa.reset_counts()
    assert tfa.flash_attention.launches_by_design == {"A": 0, "B": 0, "H": 0}


def test_every_kernel1_kernel_carries_flash_fwd():
    """The benchmark's roofline readers (``perfbench/metrics/
    flash_fwd_roofline.*.py``) find kernel #1's device time by the
    substring ``flash_fwd``: every ``__global__`` kernel of the library the
    wrapper builds (its source and the headers it includes) carries it, and
    the tensor-core launcher picks among those kernels only."""
    import re

    csrc = tfa._SOURCE.parent
    source = tfa._SOURCE.read_text()
    included = re.findall(r'#include "([^"]+)"', source)
    texts = [source] + [(csrc / name).read_text() for name in included]
    kernels = {name for text in texts for name in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(", text)}
    assert {"flash_fwd_kernel", "flash_fwd_mma_a_kernel", "flash_fwd_mma_b_kernel",
            "flash_fwd_wgmma_kernel"} <= kernels
    assert all("flash_fwd" in name for name in kernels), kernels
    launcher = source[source.index("MmaKernel mma_kernel_of()"):
                      source.index("int launch_mma(")]
    assert set(re.findall(r"reinterpret_cast<const void\*>\((\w+)<", launcher)) == {
        "flash_fwd_wgmma_kernel", "flash_fwd_mma_a_kernel", "flash_fwd_mma_b_kernel"}
    reader = Path(__file__).resolve().parent.parent / "perfbench" / "metrics"
    for path in reader.glob("flash_fwd_roofline.*.py"):
        assert 'KERNELS = ("flash_fwd",)' in path.read_text(), path


def _emulate_mma(q, k, v, split=True, design=None):
    """The tensor-core route's arithmetic on bf16 ``[B, S, H, D]`` q/k/v, in
    the key tiles of ``design`` (by default the one the call takes);
    ``split=False`` takes ``p`` as one bf16 value."""
    d = q.shape[-1]
    design = design or tfa.mma_design(d, True, q.shape[1], k.shape[1])
    tile = KEY_TILES[design]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    # the wrapper passes 1/sqrt(d) as a C float; the kernel multiplies by
    # log2(e) in f32
    scale_log2 = float(np.float32(np.float32(1.0 / d**0.5) * np.float32(LOG2E)))
    m = torch.full(qf.shape[:3], -1e30)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, kf.shape[2], tile):
        raw = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        x = raw * scale_log2
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        if design == "H":  # exp2(fma(raw, scale_log2, -m)): one rounding, as f64 then f32
            p = torch.exp2((raw.double() * scale_log2 - m_new.double()[..., None]).float())
        else:
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


def _over_gate(case, split, seed=0, design=None):
    """The emulation's worst element over the one-ulp gate, against the
    Pallas kernel in interpret mode."""
    b, sq, sk, h, d = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
               .to(torch.bfloat16) for s in (sq, sk, sk))
    ref = np.asarray(_flash_interpret(*(jnp.asarray(x.float().numpy()) for x in (q, k, v))))
    out = _emulate_mma(q, k, v, split=split, design=design).float().numpy()
    return float((np.abs(out - ref) / (RTOL * np.abs(ref) + ATOL)).max())


@pytest.mark.parametrize("case", CASES)
def test_split_p_arithmetic_within_one_ulp_of_pallas(case):
    assert _over_gate(case, split=True) <= 1.0


@pytest.mark.parametrize("case", CASES + H_CASES)
def test_design_h_tile_order_within_one_ulp_of_pallas(case):
    """Design H's 128-key tiles and its fused exponent, with the split
    ``p``, at every case (its own widths 64 / 128 among them)."""
    assert _over_gate(case, split=True, design="H") <= 1.0


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
