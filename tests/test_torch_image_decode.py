"""consolver_torch's JPEG decoder (``utils/jpeg.py``) and its image reader
by content (``utils/image.py``) against PIL, which the JAX package reads
every image with.

* Every fixture under ``tests/data/jpeg/`` (written by PIL with
  ``make_fixtures.py``) decodes bit-equal to PIL's decode, and to the PNG of
  that decode committed beside it (the GPU machine has no PIL; its smoke
  phase holds the decoder to those PNGs).
* Random images, sizes and save options decode bit-equal to PIL too, and
  so does a photo-like texture (``time_decode.py``, which also times the
  decoder on such a photo at 1024 x 1024).
* ``read_image`` picks the codec from the bytes, not the file name.
* Arithmetic coding, 12-bit samples, lossless frames and CMYK raise a
  ``ValueError`` that names the SOF marker.
* ``evaluate_consistency`` over a folder of ``.jpg`` pairs gives the JAX
  package's statistics (1e-5; the port read no JPEG before).
"""

import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from consolver_torch.eval import consistency as tcons
from consolver_torch.rewards import registry as treg
from consolver_torch.utils import image as timage
from consolver_torch.utils import jpeg as tjpeg
from consolver_torch.utils.png import decode_png, encode_png
from consolver_tpu.eval import consistency as jcons
from consolver_tpu.rewards import registry as jreg

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
JPEGS = sorted(FIXTURES.glob("*.jpg"))
_spec = importlib.util.spec_from_file_location("time_decode", FIXTURES / "time_decode.py")
time_decode = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(time_decode)


def _pil(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)))


def _jpeg(arr: np.ndarray, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def test_fixtures_cover_the_decoder_and_stay_small():
    names = {p.stem for p in JPEGS}
    assert {"rgb444_q95", "rgb420_q75", "rgb422_q85", "gray_q90", "progressive_420",
            "restart_420", "odd_420_37x29", "big_420_512"} <= names
    assert all(p.with_suffix(".png").exists() for p in JPEGS)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200_000


@pytest.mark.parametrize("path", JPEGS, ids=lambda p: p.stem)
def test_fixture_decodes_bit_equal_to_pil(path):
    raw = path.read_bytes()
    got = tjpeg.decode_jpeg(raw)
    want = _pil(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    committed = decode_png(path.with_suffix(".png").read_bytes())
    np.testing.assert_array_equal(timage.decode_image(raw), committed)


@pytest.mark.parametrize("seed", range(6))
def test_random_images_decode_bit_equal_to_pil(seed):
    """Sizes from 1 to 80 pixels, noise and smooth fields, every subsampling,
    quality 5-99, progressive, restart intervals and optimized tables."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        w, h = (int(v) for v in rng.integers(1, 80, 2))
        if rng.random() < 0.5:
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            y, x = np.mgrid[0:h, 0:w]
            arr = ((np.stack([np.sin(x / 4), np.cos(y / 3), np.sin((x + y) / 5)], -1) + 1)
                   * 127).astype(np.uint8)
        opts = dict(quality=int(rng.integers(5, 100)), progressive=bool(rng.random() < 0.4),
                    optimize=bool(rng.random() < 0.3))
        if rng.random() < 0.2:
            arr = arr[..., 0]
        else:
            opts["subsampling"] = int(rng.integers(0, 3))
        if rng.random() < 0.3:
            opts["restart_marker_blocks"] = int(rng.integers(1, 5))
        raw = _jpeg(arr, **opts)
        np.testing.assert_array_equal(tjpeg.decode_jpeg(raw), _pil(raw), err_msg=str(opts))


def test_photo_like_texture_decodes_bit_equal_to_pil():
    """Every block's AC bands filled, as in the photos the decoder reads;
    the timing script's own rows report bit-equal decodes too."""
    rows = time_decode.main(["--size", "192", "--repeats", "1"])
    assert [row["bit_equal"] for row in rows] == [True, True]
    assert rows[0]["shape"] == [192, 192, 3]
    raw = _jpeg(time_decode.photo(96, 7), quality=95, subsampling=1, progressive=True)
    np.testing.assert_array_equal(tjpeg.decode_jpeg(raw), _pil(raw))


def test_read_image_goes_by_content_not_name(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    png_named_jpg = tmp_path / "edited_image.jpg"
    png_named_jpg.write_bytes(encode_png(arr))
    np.testing.assert_array_equal(timage.read_image(str(png_named_jpg)), arr)
    raw = _jpeg(arr, quality=90)
    jpeg_named_png = tmp_path / "photo.png"
    jpeg_named_png.write_bytes(raw)
    np.testing.assert_array_equal(timage.read_image(str(jpeg_named_png)), _pil(raw))
    gray = _jpeg(arr[..., 1], quality=90)
    (tmp_path / "gray.jpeg").write_bytes(gray)
    want = np.asarray(Image.open(io.BytesIO(gray)).convert("RGB"))
    np.testing.assert_array_equal(timage.read_image(str(tmp_path / "gray.jpeg")), want)
    with pytest.raises(ValueError, match="first bytes 474946383961"):
        timage.decode_image(b"GIF89a\x01\x00\x01\x00")


def _patched(raw: bytes, sof: int = None, precision: int = None) -> bytes:
    i = raw.index(b"\xff\xc0")
    out = bytearray(raw)
    if sof is not None:
        out[i + 1] = sof
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("case,match", [
    ("arithmetic", "SOF9 \\(arithmetic-coded sequential\\)"),
    ("arithmetic_progressive", "SOF10 \\(arithmetic-coded progressive\\)"),
    ("lossless", "SOF3 \\(lossless\\)"),
    ("12bit", "SOF0 with 12-bit samples"),
    ("cmyk", "SOF0 with 4 components"),
])
def test_unsupported_jpeg_raises_naming_the_marker(case, match):
    arr = np.random.default_rng(1).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    raw = _jpeg(arr, quality=80)
    raw = {
        "arithmetic": lambda: _patched(raw, sof=0xC9),
        "arithmetic_progressive": lambda: _patched(raw, sof=0xCA),
        "lossless": lambda: _patched(raw, sof=0xC3),
        "12bit": lambda: _patched(raw, precision=12),
        "cmyk": lambda: _cmyk(arr),
    }[case]()
    with pytest.raises(ValueError, match=match):
        tjpeg.decode_jpeg(raw)


def _cmyk(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(buf, format="JPEG", quality=80)
    return buf.getvalue()


def test_evaluate_consistency_over_jpeg_pairs_matches_jax(tmp_path):
    """The fault this decoder repairs: the JAX harness scores ``.jpg``
    pairs, and the port errored on each."""
    rng = np.random.default_rng(5)
    for sub in ("gen", "ref"):
        (tmp_path / sub).mkdir()
    for i in range(5):
        y, x = np.mgrid[0:24, 0:32]
        base = ((np.stack([np.sin(x / (3 + i)), np.cos(y / 4), np.sin((x + y) / 6)], -1) + 1)
                * 120).astype(np.uint8)
        noisy = np.clip(base + rng.integers(0, 30, base.shape), 0, 255).astype(np.uint8)
        Image.fromarray(base).save(tmp_path / "gen" / f"{i}.jpg", quality=85)
        Image.fromarray(noisy).save(tmp_path / "ref" / f"{i}.jpg", quality=70,
                                    progressive=i % 2 == 1)
    gen, ref = str(tmp_path / "gen"), str(tmp_path / "ref")
    for size in (None, (16, 12)):
        want = jcons.evaluate_consistency(jreg.make_reward_fn("image_psnr"), gen, ref,
                                          batch_size=2, size=size)
        got = tcons.evaluate_consistency(treg.make_reward_fn("image_psnr"), gen, ref,
                                         batch_size=2, size=size, device="cpu")
        assert got["num_scored"] == want["num_scored"] == 5 and not got["errors"]
        for key in ("mean", "std", "min", "max", "median"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_truncated_or_headless_streams_raise_value_error():
    raw = (FIXTURES / "rgb420_q75.jpg").read_bytes()
    sos = raw.index(b"\xff\xda")
    with pytest.raises(ValueError):
        tjpeg.decode_jpeg(raw[:sos - 30])  # cut inside a table segment
    with pytest.raises(ValueError, match="no frame header"):
        tjpeg.decode_jpeg(b"\xff\xd8\xff\xd9")
    with pytest.raises(ValueError, match="not a JPEG"):
        tjpeg.decode_jpeg(b"\x89PNG")
