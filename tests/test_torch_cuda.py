"""The hand-written CUDA kernel on the card (skipped without one).

Run on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances, held at every element against the plain version computed in f32
on the same inputs: |out - ref| <= rtol * |ref| + atol.  The kernel computes
in f32 and rounds once to the output type, so rtol is one ulp of that type
(twice the rounding error: 2^-7 for bf16, 2^-10 for f16, 0 for f32); atol
covers the f32 summation order (1e-4 in f32, where it is the whole limit).
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
