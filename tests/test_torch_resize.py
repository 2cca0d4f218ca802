"""The edit reference's crop-resize (``consolver_torch/kernels/resize.py``)
on the CPU: the crop-window tables that the CUDA kernel takes, applied by
the host's own numpy passes, against the whole resize followed by the crop,
bit for bit; the serving engine's route on a CPU pipeline (the host path,
counted as ``"host"``), with padding and on a one-rank mesh whose broadcast
batch carries the uint8 sources.  The kernel itself runs in
``tests/test_torch_resize_cuda.py``.
"""

import pickle

import numpy as np
import pytest
import torch

from consolver_torch.data.edit_prep import center_crop_resize
from consolver_torch.kernels import resize
from consolver_torch.serve.engine import EditInferenceEngine, References
from consolver_torch.utils.resize import _coefficients, lanczos_resize
from tests import torch_dist_workers as workers

# the Kontext-preferred source sizes (height, width) divided by 16, so that
# a target of 64 upscales them as 1024 upscales the originals
KONTEXT_SIZES = [(672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328), (832, 1248),
                 (880, 1184), (944, 1104), (1024, 1024), (1104, 944), (1184, 880), (1248, 832),
                 (1328, 800), (1392, 752), (1456, 720), (1504, 688), (1568, 672)]
SMALL = [(h // 16, w // 16) for h, w in KONTEXT_SIZES]
SIZE = 64


def _image(h, w, content="noise", seed=0):
    if content == "checker":  # 0 / 255 edges: the Lanczos lobes overshoot both clips
        yy, xx = np.mgrid[:h, :w]
        return np.repeat(((yy // 3 + xx // 2) % 2 * 255).astype(np.uint8)[..., None], 3, axis=2)
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("content", ["noise", "checker"])
@pytest.mark.parametrize("shape", SMALL + [(300, 200), (SIZE, SIZE), (61, 97), (97, 61)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_window_passes_equal_the_whole_resize_then_the_crop(shape, content):
    """The kernel's arithmetic on the crop window alone (``crop_resize_plain``)
    against ``lanczos_resize`` of the whole image cut to the crop, and its
    [-1, 1] floats against the host path's: at the 17 aspect ratios, a
    downscale (more taps), the identity and odd sizes."""
    h, w = shape
    img = _image(h, w, content)
    width, height, left, top = resize.crop_window(h, w, SIZE)
    want = lanczos_resize(img, width, height)[top:top + SIZE, left:left + SIZE]
    got = resize.crop_resize_plain(img, SIZE)
    np.testing.assert_array_equal(got, want)
    signed = (got.astype(np.float32) / np.float32(255.0)) * np.float32(2.0) - np.float32(1.0)
    np.testing.assert_array_equal(signed, center_crop_resize(img, SIZE) * 2.0 - 1.0)
    if content == "checker" and min(h, w) < SIZE:  # an upscale rings past both clips
        assert got.min() == 0 and got.max() == 255


@pytest.mark.parametrize("in_size,out_size,offset", [
    (42, 98, 17), (98, 64, 0), (3000, 1024, 500), (1568, 2389, 682), (200, 64, 0)])
def test_window_tables_are_rows_of_the_whole_table(in_size, out_size, offset):
    size = min(64, out_size - offset)
    first, weights = resize.window_tables(in_size, out_size, offset, size)
    whole_first, whole_weights = _coefficients(in_size, out_size, "lanczos")
    np.testing.assert_array_equal(first, whole_first[offset:offset + size])
    np.testing.assert_array_equal(weights, whole_weights[offset:offset + size])
    assert first.dtype == weights.dtype == np.int32 and not weights.flags.writeable
    assert weights.shape[1] == (7 if in_size <= out_size else 2 * int(np.ceil(
        3.0 * in_size / out_size)) + 1)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", SMALL[::4] + [(300, 200), (SIZE, SIZE)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cpu_route_equals_the_dataset_path(shape, dtype):
    """``reference_into`` on a CPU tensor (the window's numpy passes) writes
    the dataset path's ``center_crop_resize * 2 - 1``, bit for bit, and
    counts one ``"host"`` reference; a float source is cast as both cast it."""
    img = (_image(*shape, seed=shape[0]) * (1.0 if dtype == np.float32 else 1)).astype(dtype)
    out = torch.empty((SIZE, SIZE, 3), dtype=torch.float32)
    resize.reset_counts()
    assert resize.reference_into(img, SIZE, out) is out
    assert torch.equal(out, torch.from_numpy(center_crop_resize(img, SIZE) * 2.0 - 1.0))
    assert resize.launches_by_route == {"card": 0, "host": 1}


def test_kernel_wrapper_takes_no_cpu_tensor_and_builds_nothing():
    with pytest.raises(RuntimeError, match="runs on cuda"):
        resize.center_crop_resize(torch.zeros((32, 48, 3), dtype=torch.uint8), 16)
    assert resize._library is None


def _engine(pipe, **kw):
    return EditInferenceEngine(pipe, batch_size=2, flush_ms=1.0, **workers.EDIT_KW, **kw)


def _host_refs(requests, rows):
    """The references as the engine computed them before the route: the host
    resize of each row's source, stacked, times 2 minus 1."""
    refs01 = [center_crop_resize(np.asarray(requests[i].image), workers.EDIT_KW["resolution"])
              for i in rows]
    return torch.from_numpy(np.stack(refs01) * 2.0 - 1.0)


class _HostStackEngine(EditInferenceEngine):
    """The engine with its message's reference built as before the route."""

    def _message(self, requests):
        msg = super()._message(requests)
        rows = self._pad(list(range(len(requests))), requests)
        msg["inputs"] = (*msg["inputs"][:-1], _host_refs(requests, rows))
        return msg


@pytest.fixture(scope="module")
def edit_pipe():
    return workers.edit_serving_pipeline()


def test_cpu_engine_resizes_each_source_once_on_the_host(edit_pipe):
    """Batch 2 with a pad row: the padded reference equals the host path's
    stack, and the pad row copies the resized row (one host resize)."""
    req = workers.edit_request(3)
    with _engine(edit_pipe) as eng:
        resize.reset_counts()
        msg = eng._on_device(lambda: eng._message([req]))
        assert resize.launches_by_route == {"card": 0, "host": 1}
        ref = msg["inputs"][-1]
        assert ref.dtype == torch.float32 and ref.shape == (2, 16, 16, 3)
        assert torch.equal(ref, _host_refs([req], [0, 0]))
        two = eng._on_device(lambda: eng._message([req, workers.edit_request(4)]))["inputs"][-1]
        assert torch.equal(two, _host_refs([req, workers.edit_request(4)], [0, 1]))
        assert resize.launches_by_route == {"card": 0, "host": 3}
        spans = eng.spans.snapshot()
    assert spans["engine.resize"]["count"] == 2


def test_cpu_engine_serves_the_images_of_the_host_stack(edit_pipe):
    """One edit alone (a pad row) and two together: the same images as the
    engine whose message stacks the host path's references."""
    reqs = [workers.edit_request(i, deterministic=True) for i in (5, 6)]
    served = {}
    for cls in (EditInferenceEngine, _HostStackEngine):
        with cls(edit_pipe, batch_size=2, flush_ms=300.0, **workers.EDIT_KW) as eng:
            alone = eng.generate(reqs[0], timeout=300)
            futs = [eng.submit(r) for r in reqs]
            served[cls] = [alone] + [f.result(timeout=300) for f in futs]
            stats = eng.stats()
        assert stats["padded_rows"] == 1 and stats["batches"] == 2
    for got, want in zip(served[EditInferenceEngine], served[_HostStackEngine], strict=True):
        np.testing.assert_array_equal(got, want)


def test_mesh_batch_carries_the_uint8_sources(edit_pipe, monkeypatch):
    """On a mesh the broadcast batch holds the requests' uint8 sources and
    each row's source index (pickled, as the broadcast sends it); the rank
    resizes its rows, and the image is the one-card engine's."""
    req = workers.edit_request(7, deterministic=True)
    with _engine(edit_pipe) as single:
        want = single.generate(req, timeout=300)
    sent = []
    with workers.world1_mesh() as mesh:
        broadcast = mesh.broadcast_object

        def record(obj=None):
            sent.append(pickle.loads(pickle.dumps(obj)))
            return broadcast(obj)

        monkeypatch.setattr(mesh, "broadcast_object", record)
        eng = _engine(edit_pipe, mesh=mesh)
        try:
            resize.reset_counts()
            got = eng.generate(req, timeout=300)
        finally:
            eng.shutdown()
    np.testing.assert_array_equal(got, want)
    ref = sent[0]["inputs"][-1]
    assert isinstance(ref, References) and ref.rows.tolist() == [0, 0]
    assert len(ref.sources) == 1 and ref.sources[0].dtype == np.uint8
    np.testing.assert_array_equal(ref.sources[0], req.image)
    assert ref[1:].rows.tolist() == [0] and ref[1:].sources is ref.sources
    assert resize.launches_by_route == {"card": 0, "host": 1}
    assert sent[-1] is None  # the shutdown
