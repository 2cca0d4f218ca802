"""The hand-written CUDA kernels on the card (skipped without one).

Run on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances, held at every element against the plain version computed in f32
on the same inputs: |out - ref| <= rtol * |ref| + atol.  The kernel computes
in f32 and rounds once to the output type, so rtol is one ulp of that type
(twice the rounding error: 2^-7 for bf16, 2^-10 for f16, 0 for f32); atol
covers the f32 summation order (1e-4 in f32, where it is the whole limit).
Kernel #1's bf16 cases take its tensor-core route ("mma": design H at
padded widths 64, 80 and 128, and 48 past one key tile, with aligned rows;
design A at the other widths up to d = 160 and for unaligned rows; design
B above), its f32 and f16 cases
the FMA route; the ``kernel1_*`` tests assert the route from
``launches_by_route`` (and the design from ``launches_by_design``) and
cover every main-path head dim, ragged keys, packed views aligned and not,
and large scores.  The variants (kernels #2-#4) add one rounding flip of the
heaviest probability and bound the share of elements past one ulp.  Their
bf16 cases take the tensor-core route ("mma": ragged Sk and Sq, d = 80 / 72
/ 40 on cp.async copies, d = 76 and unaligned packed views staged element
by element, block_k = 1024); f32 and f16 take the FMA route.  flash_int8
takes the int8 tensor-core route ("imma") for every output type, with a
rounding flip of ``2 P max|v| / 127`` and at most 1e-5 of its elements
differing at all (it repeats its plain version's f32 steps on exact integer
products): ragged Sk 37 / 77 / 200 / 1000 x block_k 64 / 512 / 1024, d = 80
/ 72 (the head dim padded to 16), f32 / f16 / bf16 outputs.
"""

import copy

import pytest
import torch

from consolver_torch.kernels import flash_attention as fa
from consolver_torch.kernels.attention import attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 0.0, 1e-4), (torch.bfloat16, 2.0**-7, 1e-5), (torch.float16, 2.0**-10, 1e-5),
])
@pytest.mark.parametrize("shape", [
    (2, 512, 77, 8, 40), (2, 256, 256, 8, 80), (2, 64, 77, 8, 160), (1, 300, 300, 1, 512),
    (2, 200, 384, 2, 128), (1, 17, 5, 3, 24),
])
def test_kernel_matches_plain_version(cuda, shape, dtype, rtol, atol):
    b, sq, sk, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, h, d), device=cuda, generator=g).to(dtype)
    k = torch.randn((b, sk, h, d), device=cuda, generator=g).to(dtype)
    v = torch.randn((b, sk, h, d), device=cuda, generator=g).to(dtype)
    before = fa.flash_attention.launches
    out = attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and out.dtype == dtype
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert ((out.float() - ref).abs() <= rtol * ref.abs() + atol).all()


def test_strided_inputs_need_no_copies(cuda):
    """q/k/v as views of one packed projection (strided over S and H)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 128, 3, 4, 40), device=cuda, generator=g)
    q, k, v = qkv.unbind(dim=2)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    assert (out - ref).abs().max().item() <= 1e-4


def test_unsupported_calls_raise(cuda):
    q = torch.zeros((1, 8, 1, 640), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 1, 64), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


def test_tiny_unet_card_matches_cpu(cuda, monkeypatch):
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator().manual_seed(2)
    unet = UNet2DCondition(UNetConfig.tiny(), device="cpu")
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.1, generator=g)
        x, ctx = torch.randn((2, 16, 16, 4), generator=g), torch.randn((2, 77, 32), generator=g)
        t = torch.tensor([999, 10])
        ref = unet(x, t, ctx)
        out = copy.deepcopy(unet).to(cuda)(x.to(cuda), t.to(cuda), ctx.to(cuda))
    assert (out.cpu() - ref).abs().max().item() <= 1e-4


VARIANT_CASES = [  # (shape, block_k); flash_nomask takes only Sk % block_k == 0
    ((1, 256, 3, 128), 64), ((1, 512, 2, 128), 512), ((2, 128, 1, 80), 128),
]


@pytest.mark.parametrize("name,shape,block_k", [
    (name, shape, block_k) for name in ("flash_bf16", "flash_int8", "flash_nomask")
    for shape, block_k in VARIANT_CASES
] + [("flash_bf16", (2, 200, 2, 128), 128), ("flash_int8", (2, 200, 2, 128), 128)])
def test_variant_kernels_match_plain_versions(cuda, monkeypatch, name, shape, block_k):
    """Kernels #2-#4 vs their plain versions walking the same chunks, bf16.
    Limit per element: one bf16 ulp + 1e-5 + one rounding flip of the
    heaviest probability P (bf16 and nomask: 2^-7 P max|v|; int8:
    2 P max|v| / 127), as chip_smoke.py states.  Flips are rare, so at most
    0.1 % of the elements may lie past one ulp; the int8 kernel repeats its
    plain version's f32 operations on exact integer products with the same
    expf, so at most 1e-5 of its elements (none at these sizes) may differ."""
    from consolver_torch.kernels import flash_variants as fv

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(shape, device=cuda, generator=g).to(torch.bfloat16) for _ in range(3))
    kernel, plain = getattr(fv, name), getattr(fv, f"{name}_reference")
    before = kernel.launches
    out = kernel(q, k, v, block_q=block_k, block_k=block_k)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and out.dtype == torch.bfloat16
    ref = plain(q, k, v, block_q=block_k, block_k=block_k).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / shape[-1] ** 0.5
    heaviest = torch.exp(s.amax(-1) - torch.logsumexp(s, -1)).max().item()
    vmax = v.float().abs().max().item()
    flip = 2 * heaviest * vmax / 127 if name == "flash_int8" else 2.0**-7 * heaviest * vmax
    diff = (out.float() - ref).abs()
    ulp_limit = 2.0**-7 * ref.abs() + 1e-5
    assert (diff <= ulp_limit + flip).all()
    assert (diff > ulp_limit).float().mean().item() <= 1e-3
    if name == "flash_int8":
        assert (diff > 0).float().mean().item() <= 1e-5


def _variant_within_limits(name, q, k, v, block_q, block_k):
    """Runs ``name`` on the card and holds it against its plain version with
    the limits above; returns the route it took."""
    from consolver_torch.kernels import flash_variants as fv

    kernel, plain = getattr(fv, name), getattr(fv, f"{name}_reference")
    before = dict(kernel.launches_by_route)
    out = kernel(q, k, v, block_q=block_q, block_k=block_k)
    torch.cuda.synchronize()
    taken = [r for r, n in kernel.launches_by_route.items() if n != before[r]]
    assert len(taken) == 1 and kernel.launches_by_route[taken[0]] == before[taken[0]] + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = plain(q, k, v, block_q=block_q, block_k=block_k).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / q.shape[-1] ** 0.5
    heaviest = torch.exp(s.amax(-1) - torch.logsumexp(s, -1)).max().item()
    rtol = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10, torch.float32: 0.0}[q.dtype]
    atol = 1e-4 if q.dtype == torch.float32 else 1e-5
    int8 = name == "flash_int8"
    flip = (2.0 / 127 if int8 else 2.0**-7) * heaviest * v.float().abs().max().item()
    diff = (out.float() - ref).abs()
    ulp_limit = rtol * ref.abs() + atol
    assert torch.isfinite(out).all()
    assert (diff <= ulp_limit + flip).all(), (diff / (ulp_limit + flip)).max().item()
    assert (diff > ulp_limit).float().mean().item() <= 1e-3
    if int8:
        assert (diff > 0).float().mean().item() <= 1e-5
    return taken[0]


def _bf16_qkv(shape, sk, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    b, sq, h, d = shape
    return (torch.randn(shape, device=device, generator=g).to(torch.bfloat16),
            torch.randn((b, sk, h, d), device=device, generator=g).to(torch.bfloat16),
            torch.randn((b, sk, h, d), device=device, generator=g).to(torch.bfloat16))


@pytest.mark.parametrize("sk,block_k", [
    (37, 64), (37, 192), (37, 512), (200, 64), (200, 192), (200, 512),
    (1000, 64), (1000, 192), (1000, 512),
])
def test_mma_route_ragged_keys(cuda, monkeypatch, sk, block_k):
    """flash_bf16 on the tensor-core route with Sk below one tile, across
    tiles and across chunks, and Sq (100) not a multiple of 64 rows."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((2, 100, 3, 128), sk, 4, cuda)
    assert _variant_within_limits("flash_bf16", q, k, v, 64, block_k) == "mma"


@pytest.mark.parametrize("d", [80, 72, 76, 40])
def test_mma_route_narrow_heads(cuda, monkeypatch, d):
    """d < 128: columns past d zero-filled.  d = 76 has rows that are not
    16-byte aligned, so the kernel stages them element by element."""
    from consolver_torch.kernels import flash_variants as fv

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((1, 130, 2, d), 300, 5, cuda)
    want = "cp.async" if d % 8 == 0 else "elementwise"
    assert fv.staging("mma", d, fv.rows_aligned(q, k, v)) == want
    assert _variant_within_limits("flash_bf16", q, k, v, 64, 128) == "mma"
    q, k, v = _bf16_qkv((1, 256, 2, d), 256, 6, cuda)
    assert _variant_within_limits("flash_nomask", q, k, v, 128, 128) == "mma"


@pytest.mark.parametrize("name", ["flash_bf16", "flash_nomask"])
@pytest.mark.parametrize("offset", [0, 1])
def test_mma_route_packed_strided_views(cuda, monkeypatch, name, offset):
    """q/k/v as strided views of one packed [B, S, 3, H, D] tensor; with a
    one-element offset no row is 16-byte aligned (element staging)."""
    from consolver_torch.kernels import flash_variants as fv

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(7)
    flat = torch.randn(2 * 256 * 3 * 4 * 128 + offset, device=cuda, generator=g)
    qkv = flat.to(torch.bfloat16)[offset:].view(2, 256, 3, 4, 128)
    q, k, v = qkv.unbind(dim=2)
    assert fv.staging("mma", 128, fv.rows_aligned(q, k, v)) == (
        "cp.async" if offset == 0 else "elementwise")
    assert _variant_within_limits(name, q, k, v, 128, 128) == "mma"


@pytest.mark.parametrize("name", ["flash_bf16", "flash_nomask"])
def test_mma_route_block_k_1024(cuda, monkeypatch, name):
    """block_k above the FMA route's 512: two 1024-key chunks."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((1, 256, 2, 128), 2048, 8, cuda)
    assert _variant_within_limits(name, q, k, v, 256, 1024) == "mma"


@pytest.mark.parametrize("name", ["flash_bf16", "flash_nomask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_f32_and_f16_stay_on_the_fma_route(cuda, monkeypatch, name, dtype):
    """A bf16 MMA would round f32 / f16 inputs: they take the FMA kernel,
    held to one ulp of their own type (+ one flip of the heaviest p)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((1, 256, 2, 128), device=cuda, generator=g).to(dtype)
               for _ in range(3))
    assert _variant_within_limits(name, q, k, v, 128, 128) == "fma"


@pytest.mark.parametrize("block_k", [64, 512, 1024])
@pytest.mark.parametrize("sk", [37, 77, 200, 1000])
def test_imma_route_ragged_keys(cuda, monkeypatch, sk, block_k):
    """flash_int8 on the int8 tensor cores with Sk below one tile, a partial
    tile inside a chunk, and across chunks, Sq = 100."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((2, 100, 3, 128), sk, 20, cuda)
    assert _variant_within_limits("flash_int8", q, k, v, 64, block_k) == "imma"


@pytest.mark.parametrize("d", [80, 72])
def test_imma_route_narrow_heads(cuda, monkeypatch, d):
    """d < 128: the wrapper pads q / k / V^T to a multiple of 16 channels."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((1, 130, 2, d), 300, 21, cuda)
    assert _variant_within_limits("flash_int8", q, k, v, 64, 128) == "imma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_imma_route_output_types(cuda, monkeypatch, dtype):
    """The output takes q's type; every type runs int8_mma_kernel."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v = (torch.randn((1, 256, 2, 128), device=cuda, generator=g).to(dtype)
               for _ in range(3))
    assert _variant_within_limits("flash_int8", q, k, v, 128, 256) == "imma"


def test_imma_route_rejects_what_it_cannot_take(cuda):
    from consolver_torch.kernels import flash_variants as fv

    q = torch.zeros((1, 64, 2, 128), device=cuda, dtype=torch.bfloat16)
    for block_k in (96, 1088):
        with pytest.raises(ValueError, match="block_k"):
            fv.flash_int8(q, q, q, block_k=block_k)
    wide = torch.zeros((1, 64, 2, 160), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fv.flash_int8(wide, wide, wide, block_k=64)


KERNEL1_TOL = {torch.bfloat16: (2.0**-7, 1e-5), torch.float16: (2.0**-10, 1e-5),
               torch.float32: (0.0, 1e-4)}


def _kernel1_route(q, k, v, ref_rows=None):
    """Runs kernel #1 on the card, holds it to one ulp of its output type +
    atol against the f32 plain version at every element, and returns the
    route it took.  ``ref_rows`` computes the plain version that many batch
    rows at a time (its f32 score matrix would not fit at once)."""
    before = dict(fa.flash_attention.launches_by_route)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    taken = [r for r, n in fa.flash_attention.launches_by_route.items() if n != before[r]]
    assert len(taken) == 1
    assert fa.flash_attention.launches_by_route[taken[0]] == before[taken[0]] + 1
    assert out.dtype == q.dtype and out.shape == q.shape and torch.isfinite(out).all()
    rtol, atol = KERNEL1_TOL[q.dtype]
    rows = ref_rows or q.shape[0]
    over = 0.0
    for i in range(0, q.shape[0], rows):
        part = slice(i, i + rows)
        ref = fa.flash_attention_reference(q[part].float(), k[part].float(), v[part].float())
        over = max(over, ((out[part].float() - ref).abs() / (rtol * ref.abs() + atol)).max().item())
        del ref
    assert over <= 1.0, over
    return taken[0]


def _kernel1_design(q, k, v, ref_rows=None):
    """As :func:`_kernel1_route` on the "mma" route, and the tensor-core
    design that ran, from ``launches_by_design`` (exactly one launch)."""
    before = dict(fa.flash_attention.launches_by_design)
    assert _kernel1_route(q, k, v, ref_rows=ref_rows) == "mma"
    taken = {d: n - before[d] for d, n in fa.flash_attention.launches_by_design.items()
             if n != before[d]}
    assert len(taken) == 1 and list(taken.values()) == [1], taken
    return next(iter(taken))


@pytest.mark.parametrize("shape,sk,ref_rows", [
    ((2, 4429, 38, 64), 4429, 1),  # SD3.5 joint: 69 x 64 + 13 queries, 34 x 128 + 77 keys
    ((1, 8320, 24, 128), 8320, 1),  # the edit engine's FLUX joint (128 T5 tokens)
    ((1, 8704, 12, 128), 8704, 1),  # FLUX joint at TP 2
    ((2, 100, 3, 64), 77, None),  # Sk below one 128-key tile
    ((1, 130, 3, 128), 1, None),  # one key
    ((2, 200, 2, 56), 300, None),  # widths padded to 64 and 128: columns past d read as zeros
    ((1, 257, 2, 120), 257, None),
    ((2, 1024, 8, 40), 1024, None),  # SD-1.5 widths 48 and 80, on the 64 and 128 kernels
    ((2, 256, 8, 80), 77, None),
], ids=["sd35_joint", "flux_joint_t5_128", "flux_joint_tp2", "ragged_below_tile", "one_key",
        "d56", "d120", "sd_width48_self", "sd_width80_cross"])
def test_kernel1_design_h(cuda, monkeypatch, shape, sk, ref_rows):
    """Design H (wgmma + TMA) at the joint attentions, at SD-1.5's widths 48
    and 80 and at ragged lengths, held to one bf16 ulp + 1e-5 at every
    element."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv(shape, sk, 40, cuda)
    assert fa.mma_design(shape[-1], fa.rows_aligned(q, k, v), shape[1], sk) == "H"
    assert _kernel1_design(q, k, v, ref_rows=ref_rows) == "H"


@pytest.mark.parametrize("sk,want", [(77, "A"), (128, "A"), (129, "H")])
def test_kernel1_width_48_by_key_length(cuda, monkeypatch, sk, want):
    """At width 48 (SD-1.5's d = 40) one key tile stays on design A (the
    77-key cross-attention ran faster there); more keys go to H."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((2, 512, 8, 40), sk, 42, cuda)
    assert _kernel1_design(q, k, v) == want


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel1_design_by_staging(cuda, monkeypatch, d, offset):
    """q/k/v as strided views of one packed [B, S, 3, H, D] tensor: aligned,
    design H reads them through its tensor maps; offset by one element, no
    row is 16-byte aligned and the call goes to design A (element
    staging).  ``launches_by_design`` counts each."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(41)
    flat = torch.randn(2 * 300 * 3 * 2 * d + offset, device=cuda, generator=g)
    q, k, v = flat.to(torch.bfloat16)[offset:].view(2, 300, 3, 2, d).unbind(dim=2)
    want = "H" if offset == 0 else "A"
    assert fa.mma_design(d, fa.rows_aligned(q, k, v), 300, 300) == want
    before = dict(fa.flash_attention.launches_by_design)
    assert _kernel1_design(q, k, v) == want
    assert _kernel1_design(q[:, :257], k, v) == want
    after = fa.flash_attention.launches_by_design
    assert {x: after[x] - before[x] for x in after} == {"A": 0, "B": 0, "H": 0, want: 2}


@pytest.mark.parametrize("shape,sk,ref_rows", [
    ((160, 4096, 8, 40), 4096, 16),  # SD-1.5 PPO rollout: 80 prompts under CFG, L0 self
    ((160, 4096, 8, 40), 77, 160),  # and its cross-attention
    ((10, 8704, 24, 128), 8704, 1),  # FLUX-Kontext PPO: one rank's group of 10, joint
], ids=["sd_ppo_l0_self", "sd_ppo_l0_cross", "flux_ppo_joint"])
def test_kernel1_at_the_training_batches(cuda, monkeypatch, shape, sk, ref_rows):
    """The PPO rollouts' largest launches (up to 2.7e8 elements per operand,
    64-bit strides in the kernel) on the tensor-core route."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv(shape, sk, 12, cuda)
    assert _kernel1_route(q, k, v, ref_rows=ref_rows) == "mma"


@pytest.mark.parametrize("d", [20, 24, 40, 80, 128, 160, 256, 300, 512])
def test_kernel1_mma_route_head_dims(cuda, monkeypatch, d):
    """bf16 at every main-path head dim (design A: 24-160; design B: 256,
    512), and d = 20 / 300, whose rows are staged element by element."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((2, 130, 2, d), 300, 10 + d, cuda)
    want = "cp.async" if d % 8 == 0 else "elementwise"
    assert fa.staging("mma", d, fa.rows_aligned(q, k, v)) == want
    assert _kernel1_route(q, k, v) == "mma"


@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("sk", [77, 200, 1000])
def test_kernel1_mma_route_ragged_keys(cuda, monkeypatch, sk, d):
    """Sk not a multiple of the key tile (77: a second tile of 13 keys) and
    Sq = 100, in both designs."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((2, 100, 2, d), sk, 11, cuda)
    assert _kernel1_route(q, k, v) == "mma"


@pytest.mark.parametrize("d", [40, 512])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel1_mma_route_packed_strided_views(cuda, monkeypatch, d, offset):
    """q/k/v as views of one packed [B, S, 3, H, D] tensor, read without
    copies; offset by one element, no row is 16-byte aligned (element
    staging)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(12)
    flat = torch.randn(2 * 256 * 3 * 2 * d + offset, device=cuda, generator=g)
    q, k, v = flat.to(torch.bfloat16)[offset:].view(2, 256, 3, 2, d).unbind(dim=2)
    assert fa.staging("mma", d, fa.rows_aligned(q, k, v)) == (
        "cp.async" if offset == 0 else "elementwise")
    assert _kernel1_route(q, k, v) == "mma"


@pytest.mark.parametrize("d", [128, 512])
def test_kernel1_mma_route_large_scores(cuda, monkeypatch, d):
    """q = k = 10: every score is 100 d, and the online softmax stays finite."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q = torch.full((1, 128, 1, d), 10.0, device=cuda, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(13)
    v = torch.randn((1, 128, 1, d), device=cuda, generator=g).to(torch.bfloat16)
    assert _kernel1_route(q, q.clone(), v) == "mma"


@pytest.mark.parametrize("d", [40, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_kernel1_f32_and_f16_stay_on_the_fma_route(cuda, monkeypatch, dtype, d):
    """A bf16 MMA would round f32 / f16 inputs: they take the FMA kernel."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = (torch.randn((1, 130, 2, d), device=cuda, generator=g).to(dtype) for _ in range(3))
    assert _kernel1_route(q, k, v) == "fma"


def _tiny_policy_and_batch(seed):
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    g = torch.Generator().manual_seed(seed)
    net = FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, family="sd"),
                    device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0.0, 0.3, generator=g)
        conds = {"x": torch.rand((24, 2), generator=g) * 999}
        actions, probs = net.sample_action(conds, g)
    old = probs * (0.6 + 0.8 * torch.rand(probs.shape, generator=g))
    adv = torch.randn((24, 1), generator=g) * (torch.rand((24, 3), generator=g) > 0.2)
    valid = (torch.rand((24, 1), generator=g) > 0.3).float()
    return net, (conds, actions, old, adv, valid)


def test_ppo_update_card_matches_cpu(cuda, monkeypatch):
    """Two PPO updates (loss, gradient, clip, AdamW) of one policy on one
    flattened batch, on the card and on the CPU (f32, TF32 off): aux and the
    clipped gradients within 1e-5, and the parameters within 1e-5 wherever
    the gradient is clear of Adam's eps.  Near 0 Adam's step is
    ``lr * g / eps``: a gradient that cancels over the rows to ~1e-9 carries
    ~1e-10 of summation-order difference, which that step multiplies by
    ``lr / eps = 1e5``; such elements are held to the ``2 lr`` a step can
    move at most."""
    from consolver_torch.rl import ppo

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    net, batch = _tiny_policy_and_batch(13)
    config = ppo.PPOConfig(learning_rate=1e-3)
    results = []
    for device in ("cpu", cuda):
        policy = copy.deepcopy(net).to(device)
        update = ppo.make_update_fn(policy, ppo.make_optimizer(policy, config), config)
        args = [{"x": batch[0]["x"].to(device)}] + [t.to(device) for t in batch[1:]]
        auxes, grads = [], []
        for _ in range(2):
            auxes.append({k: float(v) for k, v in update(*args).items()})
            grads.append([p.grad.detach().cpu() for p in policy.parameters()])
        results.append((auxes, grads, [p.detach().cpu() for p in policy.parameters()]))
    (cpu_aux, cpu_grads, cpu_params), (card_aux, card_grads, card_params) = results
    for a, b in zip(cpu_aux, card_aux):
        for name in a:
            assert abs(a[name] - b[name]) <= 1e-5 * max(1.0, abs(a[name])), name
    for step_a, step_b in zip(cpu_grads, card_grads):
        for a, b in zip(step_a, step_b):
            assert (a - b).abs().max().item() <= 1e-5
    for i, (a, b) in enumerate(zip(cpu_params, card_params)):
        clear = torch.minimum(cpu_grads[0][i].abs(), cpu_grads[1][i].abs()) >= 1e-6
        assert torch.where(clear, a - b, 0.0).abs().max().item() <= 1e-5
        assert (a - b).abs().max().item() <= 2 * 2 * config.learning_rate


def test_tiny_ppo_train_step_on_the_card(cuda, monkeypatch):
    """Two train_steps of the tiny f32 SD stack on the card: finite, the
    policy moved, kernel #1 launched in the rollouts and decodes."""
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.rewards.registry import make_reward_fn
    from consolver_torch.rl.train import PPOTrainer, TrainConfig

    net, _ = _tiny_policy_and_batch(14)
    g = torch.Generator().manual_seed(14)
    models = [UNet2DCondition(UNetConfig.tiny(), device="cpu"),
              ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"),
              AutoencoderKL(VaeConfig.tiny(), device="cpu")]
    with torch.no_grad():
        for m in models:
            for p in m.parameters():
                p.normal_(0.0, 0.1, generator=g)
    pipe = TextToImagePipeline(*(m.to(cuda) for m in models), DiffusionSchedule.sd15(),
                               factor_net=net.to(cuda), device=cuda)
    trainer = PPOTrainer(pipe, make_reward_fn("image_psnr"),
                         TrainConfig(min_inference_steps=2, max_inference_steps=4, seed=1))
    before = [p.detach().clone() for p in net.parameters()]
    launches = fa.flash_attention.launches
    batch = {"noise": torch.randn((4, 8, 8, 4), generator=g).numpy(),
             "latent": torch.randn((4, 8, 8, 4), generator=g).numpy(),
             "prompt_ids": torch.randint(1, 50, (4, 4), generator=g).numpy()}
    for _ in range(2):
        metrics = trainer.train_step(dict(batch))
        assert all(torch.isfinite(torch.tensor(metrics[k])) for k in ("loss", "reward", "grad_norm"))
    assert trainer.global_step == 2 and fa.flash_attention.launches > launches
    assert any(not torch.equal(a, b) for a, b in zip(before, net.parameters()))


SLICE_TOL = 5e-4  # the tiny f32 stack, card vs CPU, as in chip_smoke.py


@pytest.mark.parametrize("shape,sk,ref_rows", [
    ((2, 4096, 8, 40), 4096, 2), ((2, 4096, 8, 40), 77, 2),
    ((2, 1024, 8, 80), 1024, 2), ((2, 1024, 8, 80), 77, 2),
    ((2, 256, 8, 160), 256, 2), ((2, 256, 8, 160), 77, 2),
    ((2, 64, 8, 160), 64, 2), ((2, 64, 8, 160), 77, 2),
    ((1, 8320, 24, 128), 8320, 1),
], ids=["l0_self", "l0_cross", "l1_self", "l1_cross", "l2_self", "l2_cross", "mid_self",
        "mid_cross", "flux_joint_t5_128"])
def test_kernel1_at_the_serving_shapes(cuda, monkeypatch, shape, sk, ref_rows):
    """A lone SD-1.5 request under CFG (UNet batch 2) and the edit engine's
    128 T5 tokens (4096 + 4096 + 128 joint tokens), on the tensor cores."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv(shape, sk, 20, cuda)
    assert _kernel1_route(q, k, v, ref_rows=ref_rows) == "mma"


def _tiny_sd_pipelines(cuda, factor_net=None, seed=15):
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.t2i import TextToImagePipeline

    g = torch.Generator().manual_seed(seed)
    models = [UNet2DCondition(UNetConfig.tiny(), device="cpu"),
              ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"),
              AutoencoderKL(VaeConfig.tiny(), device="cpu")]
    with torch.no_grad():
        for m in models + ([factor_net] if factor_net is not None else []):
            for p in m.parameters():
                p.normal_(0.0, 0.1, generator=g)
    return [TextToImagePipeline(*(copy.deepcopy(m).to(dev) for m in models),
                                DiffusionSchedule.sd15(),
                                factor_net=copy.deepcopy(factor_net).to(dev) if factor_net else None,
                                device=dev)
            for dev in ("cpu", cuda)]


@pytest.mark.parametrize("name", ["ddim", "ipndm", "unipc", "deis", "multistep-dpm", "amed",
                                  "dmd2", "sde-dpmsolver", "sde-dpmsolver++"])
def test_tiny_stack_zoo_card_matches_cpu(cuda, monkeypatch, name):
    """Every zoo solver on the tiny f32 stack (4 steps, CFG 3), card vs CPU
    (TF32 off); the sde variants take the same CPU-drawn per-step noise."""
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.pipelines import solver_zoo

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ids = tokenize_batch(HashTokenizer(), ["a red fox", "a bowl of ramen"], 77, vocab_size=1000)
    noise = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(16))

    def draw(i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(100 + i))

    out = []
    for pipe in _tiny_sd_pipelines(cuda):
        with torch.inference_mode():
            pids = torch.as_tensor(ids, device=pipe.device)
            context, uncond = pipe._encode(pids, pipe.uncond_ids_for(pids))
            fn = solver_zoo.make_baseline_denoise_fn(pipe.unet, pipe.schedule, name, 4, 3.0,
                                                     noise_fn=draw)
            lat = fn(None, noise.to(pipe.device), context, uncond)
            out.append((lat.cpu(), pipe.decode_latents(lat).cpu()))
    (cpu_lat, cpu_img), (card_lat, card_img) = out
    assert torch.isfinite(card_lat).all()
    assert (cpu_lat - card_lat).abs().max().item() <= SLICE_TOL
    assert (cpu_img - card_img).abs().max().item() <= SLICE_TOL


def test_engine_deterministic_slot_independence_on_the_card(cuda):
    """A deterministic request served alone and in slot 2 of a full batch
    (both at the pinned max shape) gives the same bits on the card."""
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.serve import GenerationRequest, InferenceEngine

    net = FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, num_actions=11), device="cpu")
    _, pipe = _tiny_sd_pipelines(cuda, factor_net=net, seed=17)

    def req(i):
        return GenerationRequest(prompt=f"prompt {i}", seed=100 + i, num_inference_steps=3,
                                 deterministic=True)

    with InferenceEngine(pipe, batch_size=4, batch_sizes=(1, 4), latent_size=8,
                         flush_ms=150.0) as eng:
        launches = fa.flash_attention.launches
        solo = eng.generate(req(0), timeout=300)
        futs = [eng.submit(req(i)) for i in (10, 11, 0, 13)]
        packed = [f.result(timeout=300) for f in futs]
        stats = eng.stats()
    assert fa.flash_attention.launches > launches
    assert solo.shape == (16, 16, 3) and solo.dtype.name == "uint8"
    assert (solo == packed[2]).all()
    assert stats["padded_rows"] == 3 and stats["batches"] == 2


# ------------------------------------------------------------ int8 / int4


@pytest.mark.parametrize("m,k,n", [
    (16 * 1024, 9 * 640, 640),  # UNet level-1 3x3 conv at batch 16, as its im2col GEMM
    (16 * 256, 9 * 1280, 1280),  # level-2 3x3 conv
    (16 * 256, 9 * 640, 640),  # level-1 downsample (33x33, stride 2 -> 16x16)
    (8704, 3072, 12288),  # FLUX ff_net_0
    (1, 3072, 18432),  # a FLUX modulation at batch 1: one row, padded to 17
    (16, 3072, 9216),  # 16 rows, padded too
    (17, 768, 320),
])
def test_int8_gemm_route_matches_plain_version(cuda, m, k, n):
    """cuBLASLt's int8 GEMM (``torch._int_mm``) gives the plain version's
    int32 (f64 products of int8 values, exact)."""
    from consolver_torch.kernels import quant as tq

    g = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=g, dtype=torch.int32).to(torch.int8)
    b = torch.randint(-127, 128, (n, k), device=cuda, generator=g, dtype=torch.int32).to(torch.int8)
    before = tq.int_mm.launches
    got = tq.int_mm(a, b)
    assert tq.int_mm.launches == before + 1 and got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, tq.int_mm_reference(a, b))


@pytest.mark.parametrize("shape,k,stride,pad", [
    ((16, 640, 32, 32), 3, 1, 1), ((16, 1280, 16, 16), 3, 1, 1), ((16, 640, 33, 33), 3, 2, 0),
    ((16, 960, 32, 32), 1, 1, 0),
])
def test_int8_conv_card_matches_cpu(cuda, shape, k, stride, pad):
    """An int8 UNet convolution on the card and on the CPU from the same
    bf16 input: the same quantized input, int32 and output, bit for bit."""
    from consolver_torch.kernels import quant as tq

    g = torch.Generator().manual_seed(shape[1])
    conv = torch.nn.Conv2d(shape[1], shape[1] // 2, k, stride, pad).to(torch.bfloat16)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.02, generator=g)
    layer = tq.quantize_like(tq.Int8Conv2d(shape[1], shape[1] // 2, k, stride, pad), conv)
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        want = layer(x)
        got = copy.deepcopy(layer).to(cuda)(x.to(cuda)).cpu()
    assert torch.equal(got, want)


def test_int4_dense_card_matches_plain_version(cuda):
    """W4A16 at the FLUX ff shape: the bf16 GEMM on the same bf16 weights as
    an f32 GEMM rounded where the card rounds, within one bf16 ulp of the
    largest output."""
    from consolver_torch.kernels import quant as tq

    g = torch.Generator(device=cuda).manual_seed(4)
    linear = torch.nn.Linear(3072, 12288, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        linear.weight.normal_(0.0, 0.02, generator=g)
    layer = tq.quantize_like(tq.Int4Linear(3072, 12288), linear)
    x = torch.randn((8704, 3072), device=cuda, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        got = layer(x).float()
        w = tq.dequantize_int4(layer.kernel_packed, layer.kernel_scale, torch.bfloat16)
        want = ((x.float() @ w.float()).to(torch.bfloat16) + layer.bias.to(torch.bfloat16)).float()
    assert (got - want).abs().max() <= 2.0**-7 * want.abs().max()


def test_slot_invariant_route_is_slot_invariant(cuda):
    """The deterministic programs' UNet convolution route at batch 16 (a
    slot-dependent cuDNN shape: 1280 channels at 16x16): a sample's bits at
    slots 0 and 3 alike, where every row holds the same input."""
    from consolver_torch.models.layers import slot_invariant_conv

    g = torch.Generator(device=cuda).manual_seed(5)
    conv = torch.nn.Conv2d(1280, 1280, 3, padding=1, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.02, generator=g)
        row = torch.randn((1, 1280, 16, 16), device=cuda, generator=g).to(torch.bfloat16)
        others = torch.randn((15, 1280, 16, 16), device=cuda, generator=g).to(torch.bfloat16)
        at0 = slot_invariant_conv(conv, torch.cat([row, others]))[0]
        at3 = slot_invariant_conv(conv, torch.cat([others[:3], row, others[3:]]))[3]
        same = slot_invariant_conv(conv, row.expand(16, -1, -1, -1).contiguous())
    assert torch.equal(at0, at3)
    assert all(torch.equal(same[i], same[0]) for i in range(16))


@pytest.mark.parametrize("shape,sk,ref_rows", [
    ((20, 257, 12, 64), 257, 20),  # DINOv2-base, a FLUX PPO reward call
    ((64, 257, 16, 64), 257, 64),  # CLIP-L/14
    ((80, 1370, 6, 64), 1370, 8),  # Depth-Anything-V2-S, an SD PPO step's 80 images
    ((8, 16384, 1, 64), 256, 8),  # SegFormer-b4 stages 1-4, keys reduced to 256
    ((8, 4096, 2, 64), 256, 8),
    ((8, 1024, 5, 64), 256, 8),
    ((8, 256, 8, 64), 256, 8),
], ids=["dino_base", "clip_l14", "depth_anything_s", "segformer_s1", "segformer_s2",
        "segformer_s3", "segformer_s4"])
def test_kernel1_at_the_backbone_shapes(cuda, monkeypatch, shape, sk, ref_rows):
    """The reward and eval backbones' attention (head dim 64, design H at
    width 64): ragged 257 / 1370 keys, Sq != Sk up to 16384 queries, a batch
    of 80 x 6 heads, on the tensor cores."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv(shape, sk, 30, cuda)
    assert fa.mma_design(64) == "H" and fa.padded_width(64, "mma") == 64
    assert _kernel1_design(q, k, v, ref_rows=ref_rows) == "H"


def _tiny_backbones(seed):
    from consolver_torch.models.depth_anything import DepthAnything, DepthAnythingConfig
    from consolver_torch.models.inception import InceptionV3
    from consolver_torch.models.segformer import Segformer, SegformerConfig
    from consolver_torch.models.vit import ViT, ViTConfig

    torch.manual_seed(seed)
    clip = ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
                     layerscale=False, quick_gelu=True, pre_norm_embed=True, patch_bias=False,
                     projection_dim=16, ln_eps=1e-5)
    return {"dino": ViT(ViTConfig.tiny(), device="cpu"), "clip": ViT(clip, device="cpu"),
            "depth": DepthAnything(DepthAnythingConfig.tiny(), device="cpu"),
            "segment": Segformer(SegformerConfig.tiny(), device="cpu"),
            "inception": InceptionV3(1000, device="cpu")}


@pytest.mark.parametrize("name", ["dino", "clip", "depth", "segment", "inception", "resize"])
def test_tiny_backbone_card_matches_cpu(cuda, monkeypatch, name):
    """Each tiny f32 backbone (default init; Inception's convs He-initialised
    so its features are not 1e-7) and the resize helper, card vs CPU, TF32
    off, within SLICE_TOL of the output's largest value."""
    from consolver_torch.models.depth_anything import make_depth_fn
    from consolver_torch.models.vit import make_encoder, preprocess
    from consolver_torch.utils import resize

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator().manual_seed(31)
    images = torch.rand((2, 40, 52, 3), generator=g)
    models = _tiny_backbones(32)
    with torch.no_grad():
        for m in models["inception"].modules():
            if isinstance(m, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
    calls = {
        "dino": lambda m, x: make_encoder(m, "dino")(x),
        "clip": lambda m, x: make_encoder(m, "clip")(x),
        "depth": lambda m, x: make_depth_fn(m)(x),
        "segment": lambda m, x: m(preprocess(x, 512, resize_to=None)),
        "inception": lambda m, x: m(preprocess(x, 75, resize_to=75, method="cubic")),
        "resize": lambda m, x: torch.cat([
            resize.resize(x, (2, 61, 37, 3), "linear").flatten(),
            resize.resize(x, (2, 23, 90, 3), "cubic").flatten(),
            resize.resize_align_corners(x, (81, 27)).flatten()]),
    }
    model = models.get(name)
    with torch.no_grad():
        want = calls[name](model, images)
        got = calls[name](copy.deepcopy(model).to(cuda) if model is not None else None,
                          images.to(cuda)).cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= SLICE_TOL * want.abs().max().item()


# ----------------------------------------------------- data / tensor parallel
def _two_rank_backend():
    return "nccl" if torch.cuda.device_count() >= 2 else "gloo"


def test_kernel1_at_the_tp2_flux_joint_shape(cuda, monkeypatch):
    """The FLUX joint attention at TP 2 (12 local heads of 24), on the
    tensor cores."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _bf16_qkv((1, 8704, 12, 128), 8704, 21, cuda)
    assert _kernel1_route(q, k, v, ref_rows=1) == "mma"


def test_two_rank_collectives_of_cuda_tensors(cuda):
    """Two ranks (gloo sharing one card, or NCCL with a card each) reduce,
    gather and broadcast CUDA tensors where they lie."""
    import torch_dist_workers as workers  # tests/ is on sys.path under pytest

    from consolver_torch.dist import launch

    ranks = launch.spawn(workers.card_collectives_rank, 2, backend=_two_rank_backend(),
                         timeout_s=300)
    for r in ranks:
        assert r["device"].startswith("cuda") and r["backend"] == _two_rank_backend()
        assert r["sum"] == [3.0, 3.0, 3.0] and r["gathered"] == [0.0, 1.0]
        assert r["broadcast"] == [5.0, 5.0]


def test_tp2_flux_on_the_card_matches_the_cpu(cuda):
    """A tiny f32 DiT split over two ranks on the card against the unsharded
    DiT on the CPU, within SLICE_TOL (TF32 off)."""
    import pickle

    import numpy as np
    import torch_dist_workers as workers  # tests/ is on sys.path under pytest

    from consolver_torch.dist import launch
    from consolver_torch.models.flux import FluxConfig, FluxTransformer, latent_image_ids

    cfg = FluxConfig.tiny()
    model = workers._fill(FluxTransformer(cfg, device="cpu"), torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    args = [torch.randn((2, 32, cfg.in_channels), generator=g),
            torch.randn((2, 4, cfg.joint_text_dim), generator=g),
            torch.randn((2, cfg.pooled_text_dim), generator=g),
            torch.tensor([999.0, 350.5]), torch.full((2,), 2.5),
            torch.cat([latent_image_ids(8, 8), latent_image_ids(8, 8, offset=1.0)]),
            torch.zeros((4, 3))]
    with torch.no_grad():
        ref = model(*args).numpy()
    ranks = launch.spawn(workers.tp_flux_on_card_rank, 2, backend=_two_rank_backend(),
                         timeout_s=300, args=(pickle.dumps((model, args)),))
    for r in ranks:
        assert r["device"].startswith("cuda")
        np.testing.assert_allclose(r["out"], ref, rtol=0, atol=SLICE_TOL)


def _host_rss():
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


def _peak_host_rss(fn):
    """(``fn()``, the RSS before, the largest RSS while it ran: sampled every
    2 ms by a thread)."""
    import threading
    import time

    before = _host_rss()
    peak, stop = [before], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], _host_rss())
            time.sleep(0.002)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        out = fn()
    finally:
        stop.set()
        thread.join()
    return out, before, max(peak[0], _host_rss())


def test_loader_puts_every_tensor_on_the_card_in_the_model_dtype(cuda, tmp_path):
    """A float hub checkpoint (f32 files) lands on the card in the model's
    bf16, every tensor equal to its file value cast; a quantized component
    lands verbatim (int8 kernels, f32 scales)."""
    from consolver_torch.kernels.quant import quantize_like
    from consolver_torch.models import checkpoint as ck
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig

    import dataclasses

    unet = UNet2DCondition(UNetConfig.tiny(), device="cpu")
    ck.save_file(ck.hub_state_dict(unet, "unet"), str(tmp_path / "unet.safetensors"))
    loaded = ck.load_hub(UNet2DCondition(UNetConfig.tiny(), device="meta", dtype=torch.bfloat16),
                         "unet", str(tmp_path / "unet.safetensors"), device=cuda)
    for k, v in loaded.state_dict().items():
        assert v.device.type == "cuda" and v.dtype == torch.bfloat16, k
        assert torch.equal(v.cpu(), unet.state_dict()[k].to(torch.bfloat16)), k
    qcfg = dataclasses.replace(UNetConfig.tiny(), quant_int8=True, quant_skip_levels=(0,))
    quant = quantize_like(UNet2DCondition(qcfg, device="meta"), unet)
    ck.save_component(quant, str(tmp_path / "int8"), qcfg)
    back = ck.load_component(UNet2DCondition(qcfg, device="meta"), str(tmp_path / "int8"),
                             device=cuda, verbatim=True)
    for k, v in back.state_dict().items():
        assert v.device.type == "cuda" and v.dtype == quant.state_dict()[k].dtype, k
        assert torch.equal(v.cpu(), quant.state_dict()[k]), k


def test_a_component_loads_without_a_host_copy_of_the_model(cuda, tmp_path):
    """The full-width SD-1.5 UNet as an f32 component (3.4 GB) loads onto the
    card while the host's resident memory grows by far less than the model:
    one tensor at a time, its pages of the mapping dropped once copied."""
    from consolver_torch.cli.train_sd15 import load_component_module
    from consolver_torch.models import checkpoint as ck
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig

    unet = UNet2DCondition(UNetConfig.sd15(), device="meta").to_empty(device=cuda)
    ck.save_component(unet, str(tmp_path / "unet"), UNetConfig.sd15())
    nbytes = sum(f.stat().st_size for f in (tmp_path / "unet").iterdir())
    del unet
    torch.cuda.empty_cache()

    def load():
        module = load_component_module(str(tmp_path / "unet"), "unet", UNetConfig.sd15(),
                                       torch.bfloat16, cuda)
        torch.cuda.synchronize()
        return module

    loaded, before, peak = _peak_host_rss(load)
    assert all(v.device.type == "cuda" for v in loaded.state_dict().values())
    assert nbytes > 3e9 and peak - before < nbytes / 4, (before, peak, nbytes)


def test_the_command_line_runs_on_the_card_by_default(cuda, tmp_path):
    """``python -m consolver_torch selftest`` with no --device: convert ->
    generate -> evaluate on the card."""
    from consolver_torch.__main__ import main

    assert main(["selftest", "--workdir", str(tmp_path)]) == 0


# ------------------------------------------------------- UNet CUDA graphs


@pytest.fixture
def sd15_unet(cuda):
    """The SD-1.5 UNet at its published widths in bf16, weights from a seed
    (``probes/unet_graphs.fill_``), graphs off."""
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.probes.unet_graphs import fill_

    fa.build()
    unet = UNet2DCondition(UNetConfig.sd15(), device="meta", dtype=torch.bfloat16)
    return fill_(unet.to_empty(device=cuda), seed=16)


def _graph_spans(run):
    from consolver_torch.utils import profiling

    totals = profiling.SpanTotals()
    with profiling.use(totals):
        out = run()
    snap = totals.snapshot()
    return out, {k.rpartition(".")[2]: snap[k]["count"] for k in snap if k.startswith("model.unet.")}


@pytest.mark.parametrize("rows", [2, 16])
def test_unet_graph_replays_the_eager_forward_bit_for_bit(sd15_unet, rows):
    """A lone preview's UNet call (2 rows under CFG) and a batch of 8's (16):
    the capturing call and two replays on new inputs equal the eager
    forward, and each replay returns a fresh tensor, never the graph's
    buffer."""
    from consolver_torch.probes.unet_graphs import inputs

    unet = sd15_unet
    xs = [inputs(rows, unet.conv_in.weight.device, seed) for seed in (1, 2, 3)]
    with torch.inference_mode():
        want = [unet(*x) for x in xs]
        unet.cuda_graphs.enabled = True
        got, spans = _graph_spans(lambda: [unet(*x) for x in xs])
        graph = next(iter(unet.cuda_graphs._graphs.values()))
        assert graph is not None
        assert got[2].data_ptr() != graph.output.data_ptr()
        assert not torch.equal(got[1], got[2])
    assert spans == {"capture": 1, "replay": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_unet_graph_keeps_the_slot_invariant_route_slot_invariant(sd15_unet):
    """The deterministic programs' route at a batch of 8 (16 rows under
    CFG): one sample (its two CFG rows) at every slot 0-7 among other
    samples, replayed, gives the eager forward's bits of slot 0."""
    from consolver_torch.probes.unet_graphs import inputs

    unet = sd15_unet
    dev = unet.conv_in.weight.device
    lat, t, ctx = inputs(16, dev, 4)
    one_lat, _, one_ctx = inputs(2, dev, 5)

    def at_slot(k):
        x, c = lat.clone(), ctx.clone()
        x[[k, 8 + k]], c[[k, 8 + k]] = one_lat, one_ctx
        return x, t, c

    with torch.inference_mode():
        want = unet(*at_slot(0), slot_invariant=True)[[0, 8]]
        unet.cuda_graphs.enabled = True
        got, spans = _graph_spans(lambda: [unet(*at_slot(k), slot_invariant=True)[[k, 8 + k]]
                                           for k in range(8)])
    assert spans == {"capture": 1, "replay": 7}
    assert all(torch.equal(g, want) for g in got)


def test_unet_graph_sees_weights_loaded_after_capture(sd15_unet):
    from consolver_torch.probes.unet_graphs import fill_, inputs

    unet = sd15_unet
    x = inputs(2, unet.conv_in.weight.device, 6)
    with torch.inference_mode():
        unet.cuda_graphs.enabled = True
        before = unet(*x)
    new = {k: v.clone() for k, v in fill_(copy.deepcopy(unet), seed=17).state_dict().items()}
    with torch.no_grad():
        unet.load_state_dict(new)
    with torch.inference_mode():
        got, spans = _graph_spans(lambda: unet(*x))
        want = unet._forward_eager(*x)
    assert spans == {"replay": 1}
    assert torch.equal(got, want) and not torch.equal(got, before)


def test_int8_unet_replays_its_eager_output_or_falls_back_counted(sd15_unet):
    """The hybrid int8 UNet (``quantize()``'s, level 0 bf16) at 2 rows."""
    import dataclasses

    from consolver_torch.kernels import quant as tq
    from consolver_torch.models.unet_2d import UNet2DCondition
    from consolver_torch.probes.unet_graphs import inputs

    cfg = dataclasses.replace(sd15_unet.cfg, quant_int8=True, quant_skip_levels=(0,))
    unet = tq.quantize_like(UNet2DCondition(cfg, device="meta"), sd15_unet)
    del sd15_unet
    xs = [inputs(2, unet.conv_in.weight.device, seed) for seed in (7, 8)]
    with torch.inference_mode():
        want = [unet(*x) for x in xs]
        int_mm = tq.int_mm.launches
        unet(*xs[0])
        eager_int_mm = tq.int_mm.launches - int_mm
        unet.cuda_graphs.enabled = True
        int_mm = tq.int_mm.launches
        got, spans = _graph_spans(lambda: [unet(*x) for x in xs])
    captured = list(unet.cuda_graphs.signatures.values())
    if captured == [True]:
        assert spans == {"capture": 1, "replay": 1}
        assert tq.int_mm.launches - int_mm == 2 * eager_int_mm > 0
    else:
        assert captured == [False] and spans == {"eager_fallback": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_served_batches_replay_the_unet_graph_with_eager_launch_counts(cuda, monkeypatch):
    """The tiny f32 stack served at shapes 1 and 4, 8 steps: prewarm
    captures each shape once; later batches replay all 8 steps, with the
    eager engine's images and kernel #1 launches per batch."""
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.serve import GenerationRequest, InferenceEngine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net = FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, num_actions=11), device="cpu")
    pipes = [_tiny_sd_pipelines(cuda, factor_net=net, seed=18)[1] for _ in range(2)]

    def req(i):
        return GenerationRequest(prompt=f"prompt {i}", seed=300 + i, num_inference_steps=8)

    runs = []
    for graphs_on, pipe in zip((False, True), pipes):
        with InferenceEngine(pipe, batch_size=4, batch_sizes=(1, 4), latent_size=8,
                             flush_ms=300.0) as eng:
            assert pipe.unet.cuda_graphs.enabled
            pipe.unet.cuda_graphs.enabled = graphs_on
            eng.prewarm(req(99))
            set_up = eng.stats()["spans"]
            launches, images = [], []
            for batch in ([0], [1, 2, 3, 4], [5]):
                before = fa.flash_attention.launches
                futs = [eng.submit(req(i)) for i in batch]
                images += [f.result(timeout=300) for f in futs]
                launches.append(fa.flash_attention.launches - before)
            spans = eng.stats()["spans"]
        runs.append((launches, images, set_up, spans))
    (eager_launches, eager_images, _, _), (launches, images, set_up, spans) = runs

    def count(snap, name):
        return snap.get(name, {}).get("count", 0)

    assert launches == eager_launches and min(launches) > 0
    assert all((a == b).all() for a, b in zip(images, eager_images))
    assert count(set_up, "model.unet.capture") == 2
    assert count(set_up, "model.unet.replay") == 2 * 7
    assert count(spans, "model.unet.capture") == 2
    assert count(spans, "model.unet.replay") - count(set_up, "model.unet.replay") == 3 * 8
    assert count(spans, "model.unet") - count(set_up, "model.unet") == 3 * 8
