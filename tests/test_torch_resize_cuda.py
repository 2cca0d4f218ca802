"""The edit reference's crop-resize kernel (``consolver_torch/csrc/resize.cu``)
on the card (skipped without one).

Run on a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_resize_cuda.py -m cuda -q

The kernel repeats the host path's integer arithmetic on the crop window,
so its float32 output is held bit-equal (``torch.equal``) to
``center_crop_resize(src, 1024) * 2 - 1`` on the host: at the 17
Kontext-preferred source sizes, a downscale (19 taps), the identity, odd
sizes, and content that rings past both clips.
"""

import time

import numpy as np
import pytest
import torch

from consolver_torch.data.edit_prep import center_crop_resize
from consolver_torch.kernels import resize
from consolver_torch.serve.engine import References

pytestmark = pytest.mark.cuda

KONTEXT_SIZES = [(672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328), (832, 1248),
                 (880, 1184), (944, 1104), (1024, 1024), (1104, 944), (1184, 880), (1248, 832),
                 (1328, 800), (1392, 752), (1456, 720), (1504, 688), (1568, 672)]
SIZE = 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _image(h, w, content="noise", seed=0):
    if content == "checker":  # 0 / 255 edges: the Lanczos lobes overshoot both clips
        yy, xx = np.mgrid[:h, :w]
        return np.repeat(((yy // 3 + xx // 2) % 2 * 255).astype(np.uint8)[..., None], 3, axis=2)
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _host(img):
    return torch.from_numpy(center_crop_resize(img, SIZE) * 2.0 - 1.0)


@pytest.mark.parametrize("content,shape", [("noise", s) for s in KONTEXT_SIZES] + [
    ("noise", (2000, 3000)), ("noise", (3000, 2000)), ("noise", (997, 1531)),
    ("noise", (1531, 997)), ("checker", (672, 1568)), ("checker", (1024, 1024)),
    ("checker", (997, 1531)), ("checker", (2000, 3000))], ids=lambda v: (
        f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v))
def test_kernel_is_bit_equal_to_the_host_path(cuda, content, shape):
    h, w = shape
    img = _image(h, w, content, seed=h * 7 + w)
    resize.reset_counts()
    got = resize.center_crop_resize(torch.from_numpy(img).to(cuda), SIZE)
    torch.cuda.synchronize()
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == torch.float32
    assert torch.equal(got.cpu(), _host(img))
    assert resize.launches_by_route == {"card": 1, "host": 0}


def test_downscale_takes_more_than_seven_taps():
    width, _, left, _ = resize.crop_window(2000, 3000, SIZE)
    assert resize.window_tables(3000, width, left, SIZE)[1].shape[1] > 7


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    img = torch.zeros((64, 96, 3), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        resize.center_crop_resize(img, 32)
    with pytest.raises(TypeError, match="uint8"):
        resize.center_crop_resize(img.to(cuda).float(), 32)
    with pytest.raises(ValueError, match="contiguous"):
        resize.center_crop_resize(img.to(cuda).transpose(0, 1), 32)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        resize.center_crop_resize(torch.zeros((64, 96, 4), dtype=torch.uint8, device=cuda), 32)
    with pytest.raises(ValueError, match="out must be"):
        resize.center_crop_resize(img.to(cuda), 32, out=torch.empty((32, 32, 3), device=cuda,
                                                                     dtype=torch.float16))


def test_references_resize_once_per_source_on_the_card(cuda):
    """The engine's batch of references on the card: a pad row copies its
    source's row, so two rows of one source and one of another launch twice."""
    images = [_image(688, 1504, seed=1), _image(1104, 944, seed=2)]
    resize.reset_counts()
    out = References(images, np.asarray([0, 1, 1])).resize(SIZE, cuda)
    torch.cuda.synchronize()
    assert resize.launches_by_route == {"card": 2, "host": 0}
    want = torch.stack([_host(images[0]), _host(images[1]), _host(images[1])])
    assert torch.equal(out.cpu(), want)


def test_reference_upload_does_not_wait_for_queued_work(cuda):
    """The engine's route uploads from pinned memory on the current stream:
    with half a second of work queued on the card, the host returns at once,
    and the reference still equals the host path's."""
    img = _image(880, 1184, seed=3)
    out = torch.empty((SIZE, SIZE, 3), dtype=torch.float32, device=cuda)
    resize.reference_into(img, SIZE, out)  # the tables and a pinned block, first use
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(2 ** 30)
    end.record()
    t0 = time.perf_counter()
    resize.reference_into(img, SIZE, out)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    queued_s = start.elapsed_time(end) / 1e3
    assert queued_s > 0.1 and host_s < queued_s / 4, (host_s, queued_s)
    assert torch.equal(out.cpu(), _host(img))
