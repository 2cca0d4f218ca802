"""consolver_torch.configs.config, utils.trees / logging and
data.prompts against the JAX package's counterparts.

The presets are held to ``consolver_tpu.configs.config.ExperimentConfig``
field by field (every section, nested ones included), and every config
class has the JAX class's fields in the same order, so a JAX-written
sidecar or override file reads into the port.  Overrides, unknown fields
and the command line mirror ``tests/test_eval_and_config.py``; the
utilities ``tests/test_aux.py`` and ``tests/test_data.py``.  Nothing here
is numeric beyond exact equality.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.configs import config as tc
from consolver_torch.data.prompts import read_prompts
from consolver_torch.utils.logging import MetricLogger
from consolver_torch.utils.trees import cast_floating
from consolver_tpu.configs import config as jc
from consolver_tpu.data.prompts import read_prompts as jax_read_prompts
from consolver_tpu.utils.trees import cast_floating as jax_cast_floating

SECTIONS = ("model", "data", "dist", "reward", "factor_net", "train")


def _as_dict(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("preset", ["sd15_ppo", "flux_ppo", "default"])
def test_presets_equal_the_jax_presets(preset):
    port = tc.PRESETS[preset]()
    jax_cfg = {"sd15_ppo": jc.ExperimentConfig.sd15_ppo, "flux_ppo": jc.ExperimentConfig.flux_ppo,
               "default": jc.ExperimentConfig}[preset]()
    for section in SECTIONS:
        assert _as_dict(getattr(port, section)) == _as_dict(getattr(jax_cfg, section)), section


def _classes(cfg_cls, seen=None):
    """Every dataclass reachable from ``cfg_cls`` through its fields."""
    seen = {} if seen is None else seen
    seen[cfg_cls.__name__] = cfg_cls
    for f in dataclasses.fields(cfg_cls):
        default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if dataclasses.is_dataclass(default):
            _classes(type(default), seen)
    return seen


def test_every_config_class_has_the_jax_fields():
    port, jax_classes = _classes(tc.ExperimentConfig), _classes(jc.ExperimentConfig)
    assert sorted(port) == sorted(jax_classes)
    for name in port:
        assert [f.name for f in dataclasses.fields(port[name])] == \
            [f.name for f in dataclasses.fields(jax_classes[name])], name


def test_overrides_match_jax():
    overrides = {"train.ppo.learning_rate": "3e-4", "data.batch_size": "16",
                 "model.family": "flux", "data.shuffle": "true",
                 "model.quantize_rollout": "1", "model.quantize_bits": "4",
                 "reward.encoder_checkpoint": "none", "train.checkpoints_total_limit": "null",
                 "dist.data_parallel": "2"}
    port = tc.apply_overrides(tc.ExperimentConfig(), overrides)
    assert port.train.ppo.learning_rate == 3e-4 and port.data.batch_size == 16
    assert port.model.family == "flux" and port.data.shuffle is True
    assert port.model.quantize_rollout is True and port.model.quantize_bits == 4
    jax_cfg = jc.apply_overrides(jc.ExperimentConfig(), overrides)
    for section in SECTIONS:
        assert _as_dict(getattr(port, section)) == _as_dict(getattr(jax_cfg, section))
    # an already-typed value passes as it is
    assert tc.apply_overrides(port, {"data.batch_size": 7}).data.batch_size == 7


def test_unknown_field_raises():
    with pytest.raises(KeyError):
        tc.apply_overrides(tc.ExperimentConfig(), {"train.nonexistent": "1"})
    with pytest.raises(KeyError):
        tc.apply_overrides(tc.ExperimentConfig(), {"nosection.x": "1"})


def test_cli_and_the_device_flag():
    cfg = tc.parse_cli(["--preset", "flux_ppo", "--set", "train.max_train_steps=5"])
    assert cfg.train.max_train_steps == 5 and cfg.factor_net.family == "fm"
    cfg, device = tc.parse_args(["--set", "data.batch_size=3", "--device", "cpu"])
    assert cfg.data.batch_size == 3 and device == "cpu"
    assert tc.parse_args([])[1] is None  # the card by default
    assert _as_dict(tc.parse_cli([]).train) == _as_dict(jc.parse_cli([]).train)


def test_cast_floating_casts_floats_keeps_ints():
    """``utils.trees.cast_floating`` as the JAX one: floating leaves to the
    dtype, integer ones (packed int4 / int8, token tables) untouched."""
    state = {"w": torch.ones((2, 2)), "packed": torch.ones((2,), dtype=torch.uint8),
             "ids": torch.ones((3,), dtype=torch.int64), "b": torch.zeros((1,), dtype=torch.float64)}
    out = cast_floating(state, torch.bfloat16)
    assert out["w"].dtype == out["b"].dtype == torch.bfloat16
    assert out["packed"].dtype == torch.uint8 and out["ids"].dtype == torch.int64
    jax_out = jax_cast_floating({k: v.numpy() for k, v in state.items()}, jnp.bfloat16)
    for k in state:
        assert str(jax_out[k].dtype) == str(out[k].dtype).replace("torch.", ""), k
    module = cast_floating(torch.nn.Linear(2, 3), torch.float16)
    assert module.weight.dtype == torch.float16


def test_metric_logger_jsonl(tmp_path):
    logger = MetricLogger(str(tmp_path), config={"lr": 1e-4})
    logger.log(1, {"loss": 0.5})
    logger.log(2, {"loss": 0.25, "reward": 10})
    logger.close()
    lines = open(tmp_path / "metrics.jsonl").read().strip().split("\n")
    assert len(lines) == 2
    assert json.loads(lines[1])["reward"] == 10
    assert json.loads((tmp_path / "config.json").read_text())["lr"] == 1e-4


def test_metric_logger_tensorboard_only_when_asked(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)  # absent: JSONL alone
    MetricLogger(str(tmp_path / "w"), report_to="wandb").log(1, {"loss": 1.0})
    assert (tmp_path / "w" / "metrics.jsonl").exists()
    logger = MetricLogger(str(tmp_path / "tb"), report_to="tensorboard")
    logger.log(1, {"loss": 1.0, "note": "text"})
    logger.close()
    assert any(p.name.startswith("events.") for p in (tmp_path / "tb").iterdir())


def test_read_prompts_match_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    parquet = tmp_path / "prompts.parquet"
    pd.DataFrame({"TEXT": ["a cat", "a dog", None, "a bird"]}).to_parquet(parquet)
    text = tmp_path / "p.txt"
    text.write_text("one\n\ntwo\n")
    coco = tmp_path / "captions.json"
    coco.write_text(json.dumps({"annotations": [
        {"image_id": 2, "caption": "b"}, {"image_id": 1, "caption": "a"},
        {"image_id": 1, "caption": "a2"}], "images": []}))
    assert read_prompts(str(parquet)) == ["a cat", "a dog", "a bird"]
    assert read_prompts(str(text)) == ["one", "two"]
    assert read_prompts(str(coco)) == ["a", "b"]
    for path in (parquet, text, coco):
        for n in (None, 1):
            assert read_prompts(str(path), n) == jax_read_prompts(str(path), n)
    pd.DataFrame({"other": ["x"]}).to_parquet(tmp_path / "bad.parquet")
    with pytest.raises(KeyError):
        read_prompts(str(tmp_path / "bad.parquet"))
    assert np.asarray(read_prompts(str(text), 1)).tolist() == ["one"]
