"""Boundaries of the PyTorch port, checked on a machine without a GPU.

* No file of ``consolver_torch/`` or ``chip_smoke.py`` imports jax, flax,
  optax, orbax, PIL or consolver_tpu, or calls ``torch.compile``; none
  imports the ``safetensors`` package, which a GPU host need not have (the
  port reads and writes the format itself, ``models/checkpoint.py``).
* The port never calls ``scaled_dot_product_attention``; ``chip_smoke.py``
  times it as a yardstick inside ``_library_ms`` only.
* ``device=None`` means the GPU and raises without one; importing the
  kernel module builds nothing and needs no nvcc.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "consolver_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"
BANNED_IMPORTS = ("jax", "flax", "optax", "orbax", "PIL", "consolver_tpu")
YARDSTICK_FUNCTION = "_library_ms"


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute):
                yield f.attr, f.value
            elif isinstance(f, ast.Name):
                yield f.id, None


def _is_torch_compile(name, owner):
    return name == "compile" and isinstance(owner, ast.Name) and owner.id == "torch"


def test_port_files_exist():
    """The port's modules, the serving path's included (solver zoo, preview,
    PNG codec, edit prep, policy IO, engines and HTTP), the int8 / int4
    layers, the reward and eval backbones with the eval stack, the
    distributed layer, the command line with its config, utilities and
    checkpoints, and the rest of the JAX package: images read by content
    (the JPEG decoder), the learning checks, the serve and generate-edit
    commands, LoRA merging, the policy variants and the edit scores."""
    names = {str(p.relative_to(ROOT / "consolver_torch")) for p in PORT_FILES}
    assert len(PORT_FILES) >= 95 and SMOKE.exists()
    assert {"utils/jpeg.py", "utils/image.py", "cli/learning_check.py",
            "cli/learning_check_edit.py", "cli/serve.py", "cli/generate_edit.py",
            "models/lora.py", "policy/continuous.py", "policy/mu_net.py",
            "eval/edit_scores.py"} <= names
    assert {"__main__.py", "configs/__init__.py", "configs/config.py", "utils/trees.py",
            "utils/logging.py", "utils/profiling.py", "data/prompts.py", "models/checkpoint.py",
            "probes/dp_shapes.py", "cli/__init__.py", "cli/train_sd15.py", "cli/train_flux.py",
            "cli/generate_teacher.py", "cli/generate.py", "cli/evaluate.py",
            "cli/convert_checkpoints.py", "cli/quantize_checkpoint.py", "cli/preview_demo.py",
            "cli/selftest_eval.py"} <= names
    assert {"dist/__init__.py", "dist/mesh.py", "dist/tp.py", "dist/launch.py"} <= names
    assert {"utils/png.py", "pipelines/solver_zoo.py", "pipelines/preview.py",
            "eval/gen_sweep.py", "data/edit_prep.py", "policy/io.py", "serve/engine.py",
            "serve/http.py", "kernels/quant.py", "utils/resize.py", "models/vit.py",
            "models/depth_anything.py", "models/segformer.py", "models/inception.py",
            "rewards/vlm.py", "eval/fid.py", "eval/consistency.py", "eval/dino_vis.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_or_torch_compile(path):
    tree = ast.parse(path.read_text())
    for module in _imports(tree):
        assert module.split(".")[0] not in BANNED_IMPORTS, f"{path.name} imports {module}"
    for name, owner in _called_names(tree):
        assert not _is_torch_compile(name, owner), f"{path.name} calls torch.compile"


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE], ids=lambda p: str(p.relative_to(ROOT)))
def test_transformers_only_inside_function_bodies(path):
    """The GPU host has no transformers: the VLM loaders and the tokenizer
    import it inside their bodies, never at a module's top level."""
    top_level = [node for node in ast.parse(path.read_text()).body
                 if isinstance(node, (ast.Import, ast.ImportFrom))]
    for node in top_level:
        for module in _imports(node):
            assert module.split(".")[0] != "transformers", f"{path.name} imports {module}"


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_safetensors_package(path):
    """A GPU host need not have the ``safetensors`` package: the port's own
    reader and writer take its place."""
    for module in _imports(ast.parse(path.read_text())):
        assert module.split(".")[0] != "safetensors", f"{path.name} imports {module}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_calls_sdpa(path):
    tree = ast.parse(path.read_text())
    assert "scaled_dot_product_attention" not in {n for n, _ in _called_names(tree)}
    assert "scaled_dot_product_attention" not in path.read_text()


def test_smoke_calls_sdpa_only_as_yardstick():
    tree = ast.parse(SMOKE.read_text())
    allowed = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == YARDSTICK_FUNCTION:
            allowed = {id(sub) for sub in ast.walk(node)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "scaled_dot_product_attention":
                assert id(node) in allowed, "SDPA called outside the yardstick timer"


def test_device_none_raises_without_gpu(monkeypatch):
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextToImagePipeline(None, None, None, DiffusionSchedule.sd15())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNet2DCondition(UNetConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FactorNet(FactorNetConfig())


def test_edit_family_device_none_raises_without_gpu(monkeypatch):
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.pipelines.edit import FluxKontextPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FluxKontextPipeline(None, None, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FluxTransformer(FluxConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T5Encoder(T5Config.tiny())


def test_variant_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on another device than the CPU launches the kernel or
    raises: on a meta tensor (no CUDA here) every wrapper raises."""
    from consolver_torch.kernels import flash_variants as fv

    q = torch.empty((1, 64, 2, 128), device="meta", dtype=torch.bfloat16)
    for kernel in fv.KERNELS:
        with pytest.raises(RuntimeError, match="cuda or cpu"):
            kernel(q, q, q, block_q=64, block_k=64)
    assert all(kernel.launches == 0 for kernel in fv.KERNELS) and fv._library is None


def test_import_builds_nothing_and_needs_no_nvcc(tmp_path):
    """Importing every module of the port with no nvcc on PATH builds no
    library; the CPU path of the wrapper never loads one."""
    code = (
        "import pkgutil, importlib, torch, consolver_torch\n"
        "for m in pkgutil.walk_packages(consolver_torch.__path__, 'consolver_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from consolver_torch.kernels import flash_attention as fa, flash_variants as fv\n"
        "q = torch.randn(1, 16, 2, 40)\n"
        "fa.flash_attention(q, q, q)\n"
        "assert fa._library is None and fa.flash_attention.launches == 0\n"
        "q = torch.randn(1, 64, 2, 128)\n"
        "[f(q, q, q, block_q=64, block_k=64) for f in fv.KERNELS]\n"
        "assert fv._library is None and not any(f.launches for f in fv.KERNELS)\n"
        "print(sorted(p.name for p in fa._BUILD_DIR.glob('*')) if fa._BUILD_DIR.exists() else [])\n"
    )
    env = {**os.environ, "PATH": str(tmp_path), "PYTHONPATH": str(ROOT)}
    before = sorted((ROOT / "consolver_torch/kernels/_build").glob("*"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted((ROOT / "consolver_torch/kernels/_build").glob("*")) == before
