"""The kontext-bench edit chain of the port against the JAX package's:
``eval/edit_scores.py`` (the folder-per-example layout, written and scored
by both packages), ``python -m consolver_torch generate-edit`` on the tiny
FLUX stack (folder names, ragged batches, noise per example independent of
``--batch-size``), ``evaluate edit-score`` and the VLM loaders of
``rewards/vlm.py`` on a tiny local LLaVA (``tests/vlm_fixtures.py``): the
processor's ``pixel_values`` and the generated text equal to JAX's, the
stats equal, also through a stand-in ``qwen_vl_utils``; and
``utils/resize.bilinear_resize`` bit-equal to PIL's BILINEAR.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from consolver_torch.__main__ import main
from consolver_torch.cli import generate_edit as cli_edit
from consolver_torch.cli import train_sd15
from consolver_torch.configs.config import ExperimentConfig, apply_overrides
from consolver_torch.eval import edit_scores as tscores
from consolver_torch.rewards import vlm as tvlm
from consolver_torch.utils.image import read_image
from consolver_torch.utils.resize import bilinear_resize
from consolver_tpu.eval import edit_scores as jscores
from consolver_tpu.rewards import vlm as jvlm

CPU = ["--device", "cpu"]


def _psnr(ref, instruction, edited):
    mse = float(np.mean((ref - edited) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-10)) + 0.01 * len(instruction)


def _examples(write, root, n=3, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        write(str(root), f"ex{i}", rng.random((12, 10, 3)), f"make it bluer {i}",
              rng.random((12, 10, 3)))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_write_list_and_score_match_jax(tmp_path, writer):
    """Either package's folders (PNG bytes under the .jpg names) score the
    same in both; a broken example counts as an error in both."""
    write = tscores.write_example if writer == "torch" else jscores.write_example
    _examples(write, tmp_path)
    (tmp_path / "ex9").mkdir()
    for name in tscores.EXAMPLE_FILES:
        (tmp_path / "ex9" / name).write_bytes(b"not an image")
    (tmp_path / "partial").mkdir()
    (tmp_path / "partial" / "instruction.txt").write_text("no images")
    assert tscores.EXAMPLE_FILES == jscores.EXAMPLE_FILES
    assert tscores.list_examples(str(tmp_path)) == jscores.list_examples(str(tmp_path))
    got = tscores.score_results(str(tmp_path), _psnr, output_json=str(tmp_path / "t.json"))
    want = jscores.score_results(str(tmp_path), _psnr)
    assert got["num_examples"] == want["num_examples"] == 4
    assert got["num_scored"] == want["num_scored"] == 3
    assert got["num_errors"] == want["num_errors"] == 1
    np.testing.assert_allclose([got["mean"], got["std"]], [want["mean"], want["std"]], rtol=1e-6)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    with pytest.raises(FileNotFoundError):
        tscores.score_results(str(tmp_path / "partial"), _psnr)


def test_score_results_reads_real_jpegs(tmp_path):
    """Real JPEG bytes under the .jpg names (a kontext-bench result folder
    written by another tool) score as in JAX."""
    rng = np.random.default_rng(1)
    for i in range(2):
        d = tmp_path / f"ex{i}"
        d.mkdir()
        for name in ("ref_image.jpg", "edited_image.jpg"):
            Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
                d / name, quality=80)
        (d / "instruction.txt").write_text(f"edit {i}")
    got = tscores.score_results(str(tmp_path), _psnr)
    want = jscores.score_results(str(tmp_path), _psnr)
    assert got["num_scored"] == want["num_scored"] == 2 and got["num_errors"] == 0
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-6)


def _source(root, n=3, keyed=True):
    """A kontext-bench-shaped folder: metadata.jsonl with JPEG images, the
    first records keyed, the last one by index and slug."""
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(2)
    with open(root / "metadata.jsonl", "w") as f:
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (20 + i, 24, 3), dtype=np.uint8)).save(
                root / "images" / f"im{i}.jpg", quality=90)
            rec = {"file_name": f"images/im{i}.jpg", "instruction": f"add a hat #{i}!"}
            if keyed and i < n - 1:
                rec["key"] = f"key{i}"
            f.write(json.dumps(rec) + "\n")


def test_generate_edit_layout_and_noise_per_example(tmp_path):
    _source(tmp_path / "src")
    runs = {}
    for bs in (1, 2):
        out = tmp_path / f"out{bs}"
        assert main(["generate-edit", "--source", str(tmp_path / "src"), "--out", str(out),
                     "--solver", "euler", "--steps", "2", "--batch-size", str(bs), *CPU]) == 0
        runs[bs] = out
    names = sorted(p.name for p in runs[1].iterdir())
    assert names == ["00002_add_a_hat__2_", "key0", "key1"]
    assert sorted(p.name for p in runs[2].iterdir()) == names
    assert [len(tscores.list_examples(str(r))) for r in runs.values()] == [3, 3]
    for name in names:
        a = read_image(str(runs[1] / name / "edited_image.jpg")).astype(int)
        b = read_image(str(runs[2] / name / "edited_image.jpg")).astype(int)
        assert np.abs(a - b).max() <= 1, name  # the same noise; only the batch's sums differ
        assert (runs[1] / name / "instruction.txt").read_text().startswith("add a hat #")
    noise = cli_edit.example_noise(42, [0, 1, 2], (2, 2, 4))
    np.testing.assert_array_equal(noise[1], cli_edit.example_noise(42, [1], (2, 2, 4))[0])
    assert not torch.equal(noise[0], noise[1])
    assert not torch.equal(noise[0], cli_edit.example_noise(43, [0], (2, 2, 4))[0])


@pytest.mark.parametrize("size", [(64, 64), (300, 200), (17, 23), (224, 224), (500, 20)])
def test_bilinear_resize_matches_pil(size):
    h, w = size
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((224, 224), Image.BILINEAR))
    np.testing.assert_array_equal(bilinear_resize(img, 224, 224), want)


def _generating_copy(ckpt, root):
    """The tiny LLaVA with a tokenizer that emits no ``token_type_ids``:
    on the fixture as built, ``generate`` refuses them (in both packages)."""
    import shutil

    dst = root / "tiny_llava_generating"
    shutil.copytree(ckpt, dst)
    config = json.loads((dst / "tokenizer_config.json").read_text())
    config["model_input_names"] = ["input_ids", "attention_mask"]
    (dst / "tokenizer_config.json").write_text(json.dumps(config))
    return str(dst)


def test_vlm_loaders_match_jax_on_a_tiny_llava(tiny_llava_ckpt, tmp_path):
    """The processor gets the port's uint8 arrays where JAX hands it PIL
    images: equal pixel_values, equal generated text for the llava and the
    qwen glue (and the same refusal where the tokenizer emits
    token_type_ids); evaluate edit-score gives JAX's stats; the training
    CLI's reward dispatch builds the llava / qwen_vl judges as JAX's does."""
    from transformers import AutoProcessor

    rng = np.random.default_rng(3)
    pred, target = rng.random((32, 32, 3)), rng.random((32, 32, 3))
    processor = AutoProcessor.from_pretrained(tiny_llava_ckpt, local_files_only=True)
    pil = [Image.fromarray((np.clip(x, 0, 1) * 255).astype(np.uint8)) for x in (pred, target)]
    ours = [tvlm._uint8(x) for x in (pred, target)]
    a = processor(text=["<image><image>x"], images=pil, return_tensors="pt")["pixel_values"]
    b = processor(text=["<image><image>x"], images=ours, return_tensors="pt")["pixel_values"]
    assert torch.equal(a, b)
    prompt = "Rate it ."
    loaders = ((tvlm.load_transformers_generate_fn, jvlm.load_transformers_generate_fn),
               (tvlm.load_transformers_qwen_generate_fn, jvlm.load_transformers_qwen_generate_fn))
    for tload, jload in loaders:
        with pytest.raises(ValueError, match="token_type_ids") as jerr:
            jload(tiny_llava_ckpt, "cpu")(pred, target, prompt)
        with pytest.raises(ValueError, match="token_type_ids") as terr:
            tload(tiny_llava_ckpt, "cpu")(pred, target, prompt)
        assert str(terr.value) == str(jerr.value)
    ckpt = _generating_copy(tiny_llava_ckpt, tmp_path)
    for tload, jload in loaders:
        text = tload(ckpt, "cpu")(pred, target, prompt)
        assert text and text == jload(ckpt, "cpu")(pred, target, prompt)
    _examples(tscores.write_example, tmp_path / "res", n=2)
    out = tmp_path / "edit_stats.json"
    assert main(["evaluate", "edit-score", "--results", str(tmp_path / "res"), "--judge-ckpt",
                 ckpt, "--out", str(out), *CPU]) == 0
    got = json.loads(out.read_text())
    want = jscores.score_results(str(tmp_path / "res"), jvlm.load_transformers_edit_scorer(ckpt))
    assert got["num_scored"] == want["num_scored"] == 2 and got["num_errors"] == 0
    np.testing.assert_allclose([got["mean"], got["std"]], [want["mean"], want["std"]])
    for reward in ("llava", "qwen_vl"):
        cfg = apply_overrides(ExperimentConfig.sd15_ppo(), {
            "reward.reward_type": reward, "reward.encoder_checkpoint": ckpt})
        fn = train_sd15.build_reward(cfg, "cpu")
        assert getattr(fn, "host_side", False), reward


def _stub_qwen_vl_utils(monkeypatch, seen):
    """A ``qwen_vl_utils`` whose ``process_vision_info`` reads images as the
    package's ``fetch_image`` does: an image object of PIL or a string (a
    base64 data URI here), anything else an error; a 224 x 224 image keeps
    its size under the package's ``smart_resize``."""
    import base64
    import io
    import sys
    import types

    def process_vision_info(messages):
        images = []
        for part in messages[0]["content"]:
            if part["type"] != "image":
                continue
            image = part["image"]
            if not isinstance(image, Image.Image):
                assert image.startswith("data:image") and "base64," in image, type(image)
                image = Image.open(io.BytesIO(base64.b64decode(image.split("base64,", 1)[1])))
            images.append(image.convert("RGB"))
        seen.append([np.asarray(im) for im in images])
        return images, None

    monkeypatch.setitem(sys.modules, "qwen_vl_utils",
                        types.SimpleNamespace(process_vision_info=process_vision_info))


def test_qwen_loader_through_qwen_vl_utils_matches_jax(tiny_llava_ckpt, tmp_path, monkeypatch):
    """Where ``qwen_vl_utils`` imports, the qwen glue hands it what it reads
    and gets back JAX's pixels and JAX's generated text."""
    seen = []
    _stub_qwen_vl_utils(monkeypatch, seen)
    rng = np.random.default_rng(5)
    pred, target = rng.random((48, 40, 3)), rng.random((48, 40, 3))
    ckpt = _generating_copy(tiny_llava_ckpt, tmp_path)
    prompt = "Rate it ."
    text = tvlm.load_transformers_qwen_generate_fn(ckpt, "cpu")(pred, target, prompt)
    want = jvlm.load_transformers_qwen_generate_fn(ckpt, "cpu")(pred, target, prompt)
    assert len(seen) == 2 and all(im.shape == (224, 224, 3) for im in seen[0])
    for ours, theirs in zip(*seen):
        np.testing.assert_array_equal(ours, theirs)
    assert text and text == want
