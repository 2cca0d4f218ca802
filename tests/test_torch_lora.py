"""consolver_torch's LoRA merge (``models/lora.py``) against the JAX
package's: the four cases of ``tests/test_lora.py`` on the port's
diffusers-keyed state dict, then the merged weights of every key style
(peft, kohya, the old diffusers processor) held to JAX's ``merge_lora``
after conversion (1e-6), and the pairs JAX cannot merge raising in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.models import lora as tlora
from consolver_torch.models.convert import load_jax_params
from consolver_torch.models.unet_2d import UNet2DCondition as TUNet
from consolver_torch.models.unet_2d import UNetConfig as TConfig
from consolver_tpu.models import lora as jlora
from consolver_tpu.models.unet_2d import UNet2DCondition, UNetConfig

Q = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"


@pytest.fixture(scope="module")
def unets():
    """(JAX params, the port UNet carrying them)."""
    cfg = UNetConfig.tiny()
    params = UNet2DCondition(cfg).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 4, cfg.cross_attention_dim)))
    params = jax.tree.map(np.asarray, params)
    return params, load_jax_params(TUNet(TConfig.tiny(), device="cpu"), params)


def test_collect_peft_pairs():
    sd = {f"{Q}.lora_A.weight": np.ones((4, 32), np.float32),
          f"{Q}.lora_B.weight": np.ones((32, 4), np.float32)}
    pairs = tlora.collect_lora_pairs(sd)
    assert len(pairs) == 1
    down, up, s = next(iter(pairs.values()))
    assert down.shape == (4, 32) and up.shape == (32, 4)
    assert s == 1.0  # alpha defaults to rank


def test_collect_kohya_pairs():
    k = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q"
    sd = {f"{k}_lora_down.weight": np.ones((2, 8), np.float32),
          f"{k}_lora_up.weight": np.ones((8, 2), np.float32),
          f"{k}.alpha": np.asarray(8.0)}
    pairs = tlora.collect_lora_pairs(sd)
    assert len(pairs) == 1
    _, _, s = next(iter(pairs.values()))
    assert s == 4.0  # alpha / r = 8 / 2
    assert {k: v[2] for k, v in pairs.items()} == {
        k: v[2] for k, v in jlora.collect_lora_pairs(sd).items()}


def test_merge_changes_only_target(unets):
    _, unet = unets
    sd = unet.state_dict()
    out_dim, in_dim = sd[f"{Q}.weight"].shape
    rng = np.random.default_rng(0)
    down = rng.standard_normal((2, in_dim)).astype(np.float32)
    up = rng.standard_normal((out_dim, 2)).astype(np.float32)
    merged = tlora.merge_lora(sd, {f"{Q}.lora_A.weight": down, f"{Q}.lora_B.weight": up},
                              scale=0.5)
    expected = sd[f"{Q}.weight"] + 0.5 * torch.from_numpy(up @ down)  # alpha / r = 1
    torch.testing.assert_close(merged[f"{Q}.weight"], expected, rtol=1e-5, atol=1e-6)
    changed = [k for k in sd if not torch.equal(sd[k], merged[k])]
    assert changed == [f"{Q}.weight"]
    x = torch.ones((1, 8, 8, 4))
    ctx = torch.ones((1, 4, unet.cfg.cross_attention_dim))
    merged_unet = TUNet(TConfig.tiny(), device="cpu")
    merged_unet.load_state_dict(merged)
    with torch.no_grad():
        a = unet(x, torch.tensor([10]), ctx)
        b = merged_unet(x, torch.tensor([10]), ctx)
    assert not torch.allclose(a, b)


def test_unmatched_target_raises(unets):
    _, unet = unets
    key = "down_blocks.7.attentions.0.transformer_blocks.0.attn1.to_q"
    sd = {f"{key}.lora_A.weight": np.ones((2, 8), np.float32),
          f"{key}.lora_B.weight": np.ones((8, 2), np.float32)}
    with pytest.raises(KeyError):
        tlora.merge_lora(unet.state_dict(), sd)


def _lora_files(sd, rank=3, seed=1):
    """The same random pairs on every attention projection of the first
    down block and the mid block, as peft, kohya and old-diffusers files."""
    rng = np.random.default_rng(seed)
    targets = [k[: -len(".weight")] for k in sd
               if (k.startswith("down_blocks.0.") or k.startswith("mid_block."))
               and ".attn" in k and k.endswith(".weight")]
    peft, kohya, old = {}, {}, {}
    for t in targets:
        out_dim, in_dim = sd[t + ".weight"].shape
        down = rng.standard_normal((rank, in_dim)).astype(np.float32)
        up = rng.standard_normal((out_dim, rank)).astype(np.float32)
        alpha = np.asarray(float(rng.integers(1, 8)), np.float32)
        peft[f"{t}.lora_A.weight"], peft[f"{t}.lora_B.weight"] = down, up
        peft[f"{t}.alpha"] = alpha
        flat = "lora_unet_" + t.replace(".0", "_0").replace(".", "_")
        kohya[f"{flat}_lora_down.weight"], kohya[f"{flat}_lora_up.weight"] = down, up
        kohya[f"{flat}.alpha"] = alpha
        if not t.endswith("to_out.0"):  # the old processor names to_out as to_out_lora
            stem, proj = t.rsplit(".", 1)
            old[f"{stem}.processor.{proj}_lora.down.weight"] = down
            old[f"{stem}.processor.{proj}_lora.up.weight"] = up
            old[f"{stem}.processor.{proj}.alpha"] = alpha
    return targets, {"peft": peft, "kohya": kohya, "old_diffusers": old}


@pytest.mark.parametrize("style", ["peft", "kohya", "old_diffusers"])
def test_merged_weights_match_jax(unets, style):
    params, unet = unets
    sd = unet.state_dict()
    targets, files = _lora_files(sd)
    lora = files[style]
    got = tlora.merge_lora(sd, lora, scale=0.7)
    want = load_jax_params(TUNet(TConfig.tiny(), device="cpu"),
                           jlora.merge_lora(params, lora, scale=0.7)).state_dict()
    merged = {k for k in sd if not torch.equal(sd[k], got[k])}
    assert merged == {t + ".weight" for t in targets
                      if style != "old_diffusers" or not t.endswith("to_out.0")}
    for key in sd:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-6, msg=key)
    if style == "kohya":
        peft = tlora.merge_lora(sd, files["peft"], scale=0.7)
        assert all(torch.equal(got[k], peft[k]) for k in sd)


def test_old_diffusers_to_out_and_conv_pairs_raise_in_both(unets):
    params, unet = unets
    stem = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    out_lora = {f"{stem}.processor.to_out_lora.down.weight": np.ones((2, 32), np.float32),
                f"{stem}.processor.to_out_lora.up.weight": np.ones((32, 2), np.float32)}
    with pytest.raises(KeyError):
        jlora.merge_lora(params, out_lora)
    with pytest.raises(KeyError):
        tlora.merge_lora(unet.state_dict(), out_lora)
    conv = "down_blocks.0.resnets.0.conv1"
    w = unet.state_dict()[f"{conv}.weight"]
    conv_lora = {f"{conv}.lora_A.weight": np.ones((4, w.shape[1], 3, 3), np.float32),
                 f"{conv}.lora_B.weight": np.ones((w.shape[0], 4, 1, 1), np.float32)}
    with pytest.raises(ValueError):
        jlora.merge_lora(params, conv_lora)
    with pytest.raises(ValueError, match="conv-shaped"):
        tlora.merge_lora(unet.state_dict(), conv_lora)
    with pytest.raises(KeyError):
        tlora.target_key("lora_te_text_model_encoder_layers_0_mlp_fc1")


def test_bf16_weights_merge_in_f32_and_cast_back(unets):
    _, unet = unets
    sd = {k: v.to(torch.bfloat16) for k, v in unet.state_dict().items()}
    _, files = _lora_files(unet.state_dict())
    got = tlora.merge_lora(sd, files["peft"])
    pairs = tlora.collect_lora_pairs(files["peft"])
    down, up, s = pairs[Q]
    want = (sd[f"{Q}.weight"].float() + (up @ down) * s).to(torch.bfloat16)
    assert got[f"{Q}.weight"].dtype == torch.bfloat16
    assert torch.equal(got[f"{Q}.weight"], want)
