"""The port's image IO against the imaging library the JAX package calls:
the PNG codec (``utils/png.py``), ``center_crop_resize`` and
``prepare_edit_set`` (``data/edit_prep.py``), ``save_png`` /
``generate_sweep`` / ``read_coco_captions`` (``eval/gen_sweep.py``), and the
policy checkpoint loader (``policy/io.py``) on the port's two formats.

Tolerances: decoding is bit-equal to the library's own decode; the
Lanczos crop-resize is held within 1/255 at every pixel of the JAX
package's (it repeats the library's fixed-point arithmetic, so it is
bit-equal in practice).
"""

import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from consolver_torch.data import edit_prep as tprep
from consolver_torch.eval import gen_sweep as tsweep
from consolver_torch.policy import io as tio
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
from consolver_torch.utils import png
from consolver_tpu.data import edit_prep as jprep
from consolver_tpu.eval import gen_sweep as jsweep


def _pil_png(arr, mode, **save):
    im = Image.fromarray(arr, mode)
    if mode == "P":
        im.putpalette(np.random.default_rng(1).integers(0, 256, 768, np.uint8).tolist())
    buf = io.BytesIO()
    im.save(buf, format="PNG", **save)
    return buf.getvalue()


def _smooth(h, w, channels):
    """A gradient image, which the library's adaptive filtering writes with
    every filter type."""
    y, x = np.mgrid[0:h, 0:w]
    planes = [(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)), ((x + y) * 3) % 256,
              (x * y) % 256]
    return np.stack(planes[:channels], axis=-1).astype(np.uint8)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("RGBA", 4), ("P", 1)])
def test_decode_matches_the_library(mode, channels, optimize):
    rng = np.random.default_rng(channels)
    for arr in (rng.integers(0, 256, (23, 41, channels), np.uint8), _smooth(37, 29, channels)):
        arr = arr[..., 0] if channels == 1 else arr
        raw = _pil_png(arr, mode, optimize=optimize)
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        got = png.decode_png(raw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_encode_decodes_in_the_library_and_round_trips():
    rng = np.random.default_rng(0)
    for arr in (rng.integers(0, 256, (19, 33, 3), np.uint8), _smooth(64, 48, 3),
                np.zeros((1, 1, 3), np.uint8)):
        raw = png.encode_png(arr)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(raw))), arr)
        np.testing.assert_array_equal(png.decode_png(raw), arr)
        assert png.png_size(raw) == (arr.shape[1], arr.shape[0])


def test_png_size_reads_the_header_alone():
    raw = png.encode_png(np.zeros((7000, 9000, 3), np.uint8))
    assert png.png_size(raw[:33]) == (9000, 7000)  # signature + IHDR, no pixel data
    with pytest.raises(ValueError):
        png.decode_png(raw[:33])


def _ihdr_only_png(depth, ctype, interlace, w=4, h=4):
    data = zlib.compress(b"\x00" * (h * (w * 3 * depth // 8 + 1)))
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return png.SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(b"IDAT", data) + png._chunk(
        b"IEND", b"")


def test_unsupported_inputs_raise_value_error():
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(_ihdr_only_png(8, 2, 1))
    with pytest.raises(ValueError, match="colour type 4"):  # gray + alpha
        png.decode_png(_pil_png(np.zeros((4, 4, 2), np.uint8), "LA"))
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(buf, format="PNG")
    assert png.png_size(buf.getvalue()) == (8, 8)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    for fn in (png.decode_png, png.png_size):
        with pytest.raises(ValueError, match="not a PNG"):
            fn(buf.getvalue())
    header = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)  # a 4x4 header over 64 MB of data
    bomb = png.SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(
        b"IDAT", zlib.compress(bytes(1 << 26), 9)) + png._chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="holds 53 bytes, want 52"):
        png.decode_png(bomb)
    raw = bytearray(png.encode_png(np.ones((4, 4, 3), np.uint8)))
    raw[-20] ^= 0xFF  # inside IDAT: the CRC no longer holds
    with pytest.raises(ValueError):
        png.decode_png(bytes(raw))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("shape,size", [
    ((24, 20, 3), 16),  # portrait, downscale
    ((20, 24, 3), 16),  # landscape, downscale
    ((768, 1024, 3), 1024),  # landscape, upscale 4/3
    ((90, 60, 3), 128),  # portrait, upscale
    ((300, 200, 3), 64),  # portrait, downscale x3.1
    ((33, 33, 3), 33),  # no resize, crop only
])
def test_center_crop_resize_matches_jax(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    got = tprep.center_crop_resize(img, size)
    want = jprep.center_crop_resize(img, size)
    assert got.shape == want.shape == (size, size, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1 / 255 + 1e-7
    float_img = img.astype(np.float32) / 2  # float input is cast to uint8 first
    np.testing.assert_array_equal(tprep.center_crop_resize(float_img, size),
                                  jprep.center_crop_resize(float_img, size))


def test_save_png_matches_jax(tmp_path):
    x = np.random.default_rng(3).uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32)
    x[0, :4, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255, 1.0]  # rounding boundaries
    tsweep.save_png(str(tmp_path / "t.png"), x)
    jsweep.save_png(str(tmp_path / "j.png"), x)
    want = np.asarray(Image.open(tmp_path / "j.png"))
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "t.png")), want)
    tsweep.save_png(str(tmp_path / "tensor.png"), torch.from_numpy(x))
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "tensor.png")), want)


def test_generate_sweep_and_captions(tmp_path):
    prompts = [f"prompt {i}" for i in range(5)]
    seen = []

    def generate_batch(generator, batch):
        assert len(batch) == 2
        seen.append((generator.initial_seed(), list(batch)))
        idx = np.array([int(p.split()[1]) for p in batch], np.float32)
        return np.broadcast_to((idx / 10)[:, None, None, None], (2, 4, 4, 3))

    written = tsweep.generate_sweep(generate_batch, prompts, str(tmp_path / "sweep"),
                                    batch_size=2, seed=5, device="cpu")
    assert [w.rsplit("/", 1)[1] for w in written] == [f"{i:06d}.png" for i in range(5)]
    assert seen[-1][1] == ["prompt 4", "prompt 4"]  # the last batch padded
    assert len({s for s, _ in seen}) == 3  # one generator per batch
    again = []
    tsweep.generate_sweep(lambda g, b: again.append(g.initial_seed()) or np.zeros((2, 4, 4, 3)),
                          prompts, str(tmp_path / "again"), batch_size=2, seed=5, device="cpu")
    assert again == [s for s, _ in seen]
    assert png.read_png(written[3])[0, 0, 0] == int(0.3 * 255 + 0.5)
    assert (tmp_path / "sweep" / "000004.txt").read_text() == "prompt 4"

    coco = {"annotations": [{"image_id": 9, "caption": "b"}, {"image_id": 2, "caption": "a"},
                            {"image_id": 9, "caption": "c"}]}
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(coco))
    assert tsweep.read_coco_captions(str(path)) == jsweep.read_coco_captions(str(path)) == ["a", "b"]
    assert tsweep.read_coco_captions(str(path), 1) == ["a"]


def test_prepare_edit_set_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(4)
    for i, shape in enumerate([(40, 30, 3), (30, 50, 3)]):
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(src / f"{i}.png")
        (src / f"{i}.txt").write_text(f"edit number {i}\n")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src / "2.jpg")  # not a PNG: skipped
    (src / "2.txt").write_text("a jpeg")
    (src / "3.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")  # unreadable: skipped
    (src / "3.txt").write_text("broken")
    assert tprep.read_instruction_records(str(src)) == jprep.read_instruction_records(str(src))
    assert tprep.read_instruction_pairs(str(src)) == jprep.read_instruction_pairs(str(src))
    n = tprep.prepare_edit_set(str(src), str(tmp_path / "torch"), resolution=16)
    jprep.prepare_edit_set(str(src), str(tmp_path / "jax"), resolution=16)
    assert n == 2
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == ["000000.npz", "000001.npz"]
    for name in ("000000.npz", "000001.npz"):
        with np.load(tmp_path / "torch" / name) as t, np.load(tmp_path / "jax" / name) as j:
            assert str(t["instruction"]) == str(j["instruction"])
            assert np.abs(t["ref_image"] - j["ref_image"]).max() <= 2 / 255 + 1e-6


def test_read_instruction_records_jsonl_layout(tmp_path):
    (tmp_path / "images").mkdir()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "images" / "a.png")
    lines = [{"file_name": "sub/a.png", "instruction": "x", "key": "k1"},
             {"image": "missing.png", "prompt": "y"}, {"instruction": "no image"}]
    (tmp_path / "metadata.jsonl").write_text("\n".join(json.dumps(x) for x in lines) + "\n\n")
    recs = tprep.read_instruction_records(str(tmp_path))
    assert recs == jprep.read_instruction_records(str(tmp_path))
    assert recs == [{"path": str(tmp_path / "images" / "a.png"), "instruction": "x", "key": "k1"}]


CFG = FactorNetConfig(order_dim=3, scaler_dim=0, num_actions=11, hidden_dim=16)


def _net(cfg=CFG, seed=0):
    torch.manual_seed(seed)
    return FactorNet(cfg, device="cpu")


def test_load_factor_ckpt_reads_an_export(tmp_path):
    net = _net()
    path = tio.save_factor_net(net, str(tmp_path / "export"))
    default = dataclasses.replace(CFG, num_actions=21)  # the sidecar wins over it
    for where in (str(tmp_path / "export"), path):
        cfg, state = tio.load_factor_ckpt(where, default)
        assert cfg == CFG
        assert all(torch.equal(state[k], v) for k, v in net.state_dict().items())


def test_load_factor_ckpt_reads_a_trainer_checkpoint(tmp_path):
    net = _net(seed=1)
    ckpt = tmp_path / "run" / "checkpoint-3"
    ckpt.mkdir(parents=True)
    torch.save({"policy": net.state_dict(), "optimizer": {}, "global_step": 3},
               ckpt / "state.pt")
    cfg, state = tio.load_factor_ckpt(str(ckpt), CFG)  # no sidecar: the default config
    assert cfg == CFG and torch.equal(state["head.bias"], net.head.bias)
    # a sidecar beside the checkpoint directory (in the run directory) wins
    other = dataclasses.replace(CFG, hidden_dim=8)
    (tmp_path / "run" / "factor_net_config.json").write_text(
        json.dumps(dataclasses.asdict(other)))
    with pytest.raises(ValueError, match="does not fit"):
        tio.load_factor_ckpt(str(ckpt), CFG)
    # a sibling converter sidecar is found first
    (tmp_path / "run" / "checkpoint-3_factor_net_config.json").write_text(
        json.dumps(dataclasses.asdict(CFG)))
    assert tio.load_factor_ckpt(str(ckpt), other)[0] == CFG


def test_load_factor_ckpt_mismatch_and_missing_raise(tmp_path):
    tio.save_factor_net(_net(dataclasses.replace(CFG, num_actions=21)), str(tmp_path / "e"))
    (tmp_path / "e" / "factor_net_config.json").unlink()  # no sidecar: the default decides
    with pytest.raises(ValueError, match="does not fit"):
        tio.load_factor_ckpt(str(tmp_path / "e"), CFG)
    with pytest.raises(FileNotFoundError):
        tio.load_factor_ckpt(str(tmp_path / "nothing"), CFG)
