"""Write the JPEG fixtures of ``tests/test_torch_image_decode.py`` with PIL.

Each ``<name>.jpg`` comes with ``<name>.png``, PIL's decode of it, so that
a host without PIL (the GPU machine) can hold the port's decoder to PIL's
pixels.  Run from the repository root::

  python tests/data/jpeg/make_fixtures.py
"""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (width, height, mode, save options)
FIXTURES = {
    "rgb444_q95": (48, 40, "RGB", dict(quality=95, subsampling=0)),
    "rgb420_q75": (64, 64, "RGB", dict(quality=75, subsampling=2)),
    "rgb422_q85": (56, 40, "RGB", dict(quality=85, subsampling=1)),
    "gray_q90": (45, 33, "L", dict(quality=90)),
    "progressive_420": (64, 56, "RGB", dict(quality=80, subsampling=2, progressive=True)),
    "progressive_gray": (40, 40, "L", dict(quality=70, progressive=True)),
    "restart_420": (64, 48, "RGB", dict(quality=80, subsampling=2, restart_marker_blocks=3)),
    "odd_420_37x29": (37, 29, "RGB", dict(quality=75, subsampling=2)),
    "odd_422_33x17": (33, 17, "RGB", dict(quality=90, subsampling=1)),
    "tiny_420_4x3": (4, 3, "RGB", dict(quality=90, subsampling=2)),
    "adobe_rgb": (24, 16, "RGB", dict(quality=90, keep_rgb=True)),
    "exif_420": (32, 24, "RGB", dict(quality=75, subsampling=2,
                                     exif=b"Exif\x00\x00MM\x00*\x00\x00\x00\x08" + bytes(6))),
    "big_420_512": (512, 512, "RGB", dict(quality=75, subsampling=2)),
}


def picture(width: int, height: int, seed: int) -> np.ndarray:
    """Smooth colour fields, edges and a little noise: every DCT band gets
    coefficients."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.stack([
        128 + 100 * np.sin(x / (3 + width / 9) + seed),
        128 + 100 * np.cos(y / (2 + height / 7)),
        128 + 90 * np.sin((x + y) / 11.0),
    ], axis=-1)
    img[(x // 8 + y // 8) % 5 == 0] = [230, 40, 60]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def mosaic(size: int) -> np.ndarray:
    """Flat 64-pixel tiles, a disc and one textured patch: a large image
    whose decoded PNG stays small."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    palette = np.array([[200, 30, 40], [30, 180, 60], [40, 60, 200], [220, 220, 30],
                        [20, 20, 20], [240, 240, 240], [120, 60, 160]], np.float64)
    img = palette[((x // 64 + (y // 64) * 3) % 7).astype(int)]
    patch = (x >= 200) & (x < 296) & (y >= 150) & (y < 246)
    texture = np.stack([128 + 100 * np.sin(x / 5), 128 + 100 * np.cos(y / 4),
                        128 + 90 * np.sin((x + y) / 7)], axis=-1)
    img[patch] = texture[patch]
    img[(x - 400) ** 2 + (y - 380) ** 2 < 60 ** 2] = [250, 150, 0]
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    for seed, (name, (w, h, mode, opts)) in enumerate(sorted(FIXTURES.items())):
        img = Image.fromarray(mosaic(w) if w >= 256 else picture(w, h, seed))
        if mode == "L":
            img = img.convert("L")
        path = os.path.join(HERE, name + ".jpg")
        img.save(path, "JPEG", **opts)
        Image.open(path).save(os.path.join(HERE, name + ".png"), optimize=True)


if __name__ == "__main__":
    main()
