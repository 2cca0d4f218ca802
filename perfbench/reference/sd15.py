"""Plain float32 reference of an SD-1.5 preview: CLIP-L text encoder, the
conditional UNet, the ConsistencySolver policy with its linear-multistep
combine, the DDIM update and the VAE decoder, from the published SD-1.5
design (diffusers ``UNet2DConditionModel``, ``AutoencoderKL``, ``CLIPTextModel``
configs of ``runwayml/stable-diffusion-v1-5``).

Departures from diffusers, each the served deployment's stated numerics:
GroupNorm eps 1e-5 in every resnet (the VAE's too) and in the UNet's output
norm, 1e-6 in the attention blocks and the VAE's output norms; GEGLU with
the tanh GELU; the 2x downsampler pads (0, 1) before a VALID stride-2 conv.

Weights come from a ``W(name) -> f32 tensor`` getter; names follow the
diffusers keys.  Activations are NCHW.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    attention, conv, gelu_tanh, group_norm, hash_ids, layer_norm, linear, lmm_coefficients,
    policy_probs, seed_noise, timestep_embedding, to_uint8,
)

CHUNK = 4  # previews worked out together: 8 UNet rows under CFG


# ------------------------------------------------------------------ CLIP
def clip_text(W, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids ``[B, S]`` -> final-LayerNorm hidden states ``[B, S, C]``: causal
    self-attention, quick-GELU MLP, pre-norm."""
    s = ids.shape[1]
    x = W("token_embedding.weight")[ids] + W("position_embedding.weight")[:s][None]
    heads = cfg["num_heads"]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}"
        h = layer_norm(W, f"{p}.layer_norm1", x, 1e-5)
        b, _, c = h.shape
        q, k, v = (linear(W, f"{p}.self_attn.{n}_proj", h).reshape(b, s, heads, c // heads)
                   for n in "qkv")
        x = x + linear(W, f"{p}.self_attn.out_proj", attention(q, k, v, causal=True).reshape(b, s, c))
        h = linear(W, f"{p}.mlp_fc1", layer_norm(W, f"{p}.layer_norm2", x, 1e-5))
        x = x + linear(W, f"{p}.mlp_fc2", h * torch.sigmoid(1.702 * h))
    return layer_norm(W, "final_layer_norm", x, 1e-5)


# ------------------------------------------------------------------ UNet
def resnet(W, p: str, x, temb, groups: int, eps: float = 1e-5):
    h = conv(W, f"{p}.conv1", F.silu(group_norm(W, f"{p}.norm1", x, groups, eps)), padding=1)
    if temb is not None:
        h = h + linear(W, f"{p}.time_emb_proj", F.silu(temb))[:, :, None, None]
    h = conv(W, f"{p}.conv2", F.silu(group_norm(W, f"{p}.norm2", h, groups, eps)), padding=1)
    if W.has(f"{p}.conv_shortcut.weight"):
        x = conv(W, f"{p}.conv_shortcut", x)
    return x + h


def _heads(x, heads):
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads)


def spatial_transformer(W, p: str, x, context, heads: int, groups: int):
    b, c, hh, ww = x.shape
    y = conv(W, f"{p}.proj_in", group_norm(W, f"{p}.norm", x, groups, 1e-6))
    y = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    t = f"{p}.transformer_blocks.0"
    n = layer_norm(W, f"{t}.norm1", y, 1e-5)
    a = attention(*(_heads(linear(W, f"{t}.attn1.to_{k}", n, bias=False), heads) for k in "qkv"))
    y = y + linear(W, f"{t}.attn1.to_out.0", a.reshape(b, hh * ww, c))
    n = layer_norm(W, f"{t}.norm2", y, 1e-5)
    q = _heads(linear(W, f"{t}.attn2.to_q", n, bias=False), heads)
    k = _heads(linear(W, f"{t}.attn2.to_k", context, bias=False), heads)
    v = _heads(linear(W, f"{t}.attn2.to_v", context, bias=False), heads)
    y = y + linear(W, f"{t}.attn2.to_out.0", attention(q, k, v).reshape(b, hh * ww, c))
    n = layer_norm(W, f"{t}.norm3", y, 1e-5)
    hidden, gate = linear(W, f"{t}.ff.net.0.proj", n).chunk(2, dim=-1)
    y = y + linear(W, f"{t}.ff.net.2", hidden * gelu_tanh(gate))
    y = y.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return conv(W, f"{p}.proj_out", y) + x


def unet(W, cfg: dict, sample: torch.Tensor, t: torch.Tensor, context: torch.Tensor):
    """eps prediction: sample NCHW, integer timesteps ``[B]``, context."""
    ch, groups, heads = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["attention_head_dim"]
    attn, layers = cfg["cross_attn_blocks"], cfg["layers_per_block"]
    temb = timestep_embedding(t, ch[0], cfg["flip_sin_to_cos"], cfg["freq_shift"])
    temb = linear(W, "time_embedding.linear_2", F.silu(linear(W, "time_embedding.linear_1", temb)))
    x = conv(W, "conv_in", sample, padding=1)
    skips = [x]
    for i in range(len(ch)):
        for j in range(layers):
            x = resnet(W, f"down_blocks.{i}.resnets.{j}", x, temb, groups)
            if attn[i]:
                x = spatial_transformer(W, f"down_blocks.{i}.attentions.{j}", x, context, heads,
                                        groups)
            skips.append(x)
        if i < len(ch) - 1:
            x = conv(W, f"down_blocks.{i}.downsamplers.0.conv", F.pad(x, (0, 1, 0, 1)), stride=2)
            skips.append(x)
    x = resnet(W, "mid_block.resnets.0", x, temb, groups)
    x = spatial_transformer(W, "mid_block.attentions.0", x, context, heads, groups)
    x = resnet(W, "mid_block.resnets.1", x, temb, groups)
    for i in range(len(ch)):
        level = len(ch) - 1 - i
        for j in range(layers + 1):
            x = resnet(W, f"up_blocks.{i}.resnets.{j}", torch.cat([x, skips.pop()], 1), temb, groups)
            if attn[level]:
                x = spatial_transformer(W, f"up_blocks.{i}.attentions.{j}", x, context, heads,
                                        groups)
        if i < len(ch) - 1:
            x = conv(W, f"up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(x, scale_factor=2.0, mode="nearest"), padding=1)
    x = F.silu(group_norm(W, "conv_norm_out", x, groups, 1e-5))
    return conv(W, "conv_out", x, padding=1)


# ------------------------------------------------------------------- VAE
def vae_attention(W, p: str, x, groups: int):
    b, c, hh, ww = x.shape
    t = group_norm(W, f"{p}.group_norm", x, groups, 1e-6).permute(0, 2, 3, 1).reshape(b, -1, c)
    q, k, v = (linear(W, f"{p}.to_{n}", t).reshape(b, hh * ww, 1, c) for n in "qkv")
    out = linear(W, f"{p}.to_out.0", attention(q, k, v).reshape(b, hh * ww, c))
    return out.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def vae_decode(W, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """Unscaled latents NCHW -> image NCHW in about [-1, 1]."""
    groups, layers = cfg["norm_num_groups"], cfg["layers_per_block"]
    rev = list(reversed(cfg["block_out_channels"]))
    x = conv(W, "post_quant_conv", z)
    x = conv(W, "decoder.conv_in", x, padding=1)
    x = resnet(W, "decoder.mid_block.resnets.0", x, None, groups)
    x = vae_attention(W, "decoder.mid_block.attentions.0", x, groups)
    x = resnet(W, "decoder.mid_block.resnets.1", x, None, groups)
    for i in range(len(rev)):
        for j in range(layers + 1):
            x = resnet(W, f"decoder.up_blocks.{i}.resnets.{j}", x, None, groups)
        if i < len(rev) - 1:
            x = conv(W, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(x, scale_factor=2.0, mode="nearest"), padding=1)
    x = F.silu(group_norm(W, "decoder.conv_norm_out", x, groups, 1e-6))
    return conv(W, "decoder.conv_out", x, padding=1)


def vae_encode_mean(W, cfg: dict, img: torch.Tensor) -> torch.Tensor:
    """Image NCHW in [-1, 1] -> the posterior mean, NCHW."""
    groups, layers, ch = cfg["norm_num_groups"], cfg["layers_per_block"], cfg["block_out_channels"]
    x = conv(W, "encoder.conv_in", img, padding=1)
    for i in range(len(ch)):
        for j in range(layers):
            x = resnet(W, f"encoder.down_blocks.{i}.resnets.{j}", x, None, groups)
        if i < len(ch) - 1:
            x = conv(W, f"encoder.down_blocks.{i}.downsamplers.0.conv", F.pad(x, (0, 1, 0, 1)),
                     stride=2)
    x = resnet(W, "encoder.mid_block.resnets.0", x, None, groups)
    x = vae_attention(W, "encoder.mid_block.attentions.0", x, groups)
    x = resnet(W, "encoder.mid_block.resnets.1", x, None, groups)
    x = F.silu(group_norm(W, "encoder.conv_norm_out", x, groups, 1e-6))
    moments = conv(W, "quant_conv", conv(W, "encoder.conv_out", x, padding=1))
    return moments[:, :cfg["latent_channels"]]


# -------------------------------------------------------------- schedule
def sd_alphas(cfg: dict) -> np.ndarray:
    """SD-1.5's scaled-linear alpha-bar table, in float32."""
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                        cfg["num_train_timesteps"], dtype=np.float32) ** 2
    return np.cumprod(1.0 - betas, axis=0).astype(np.float32)


def trailing_ladder(num_train: int, steps: int) -> Tuple[np.ndarray, np.ndarray]:
    ts = np.round(np.arange(num_train, 0, -num_train / steps)).astype(np.int64) - 1
    return ts, ts - num_train // steps


# -------------------------------------------------------------- a preview
def previews(weights: Dict[str, object], cfg: dict, prompts: Sequence[str], seeds: Sequence[int],
             batches: Sequence[Tuple[Sequence[int], int]], device) -> np.ndarray:
    """Served previews, worked out again: uint8 ``[N, H, W, 3]``.

    ``batches[i]`` = (the padded seed list of the batch request ``i`` was
    served in, its slot).  The policy's actions are sampled as the serving
    API states: one generator on the device per batch, seeded with the
    batch's first seed, one ``Exp(1)`` draw ``q`` of shape ``[batch,
    action_dims, num_actions]`` per step, and the action ``argmax(p / q)``
    of the row's slot."""
    pipe, pol = cfg["pipeline"], cfg["factor_net"]
    Wu, Wt, Wv, Wp = weights["unet"], weights["text_encoder"], weights["vae"], weights["factor_net"]
    steps, scale = pipe["num_inference_steps"], pipe["guidance_scale"]
    order, adims, nact = pol["order_dim"], pol["order_dim"] + pol["scaler_dim"] - 1, pol["num_actions"]
    alphas = torch.as_tensor(sd_alphas(cfg["schedule"]), device=device)
    ts, prev = trailing_ladder(cfg["schedule"]["num_train_timesteps"], steps)
    latent = pipe["resolution"] // 8
    c_in = cfg["unet"]["in_channels"]

    # the policy's actions, per request and step, from its batch's generator
    actions = torch.zeros((len(prompts), steps, adims), device=device)
    grid = _action_grid(pol, device)
    by_batch: Dict[tuple, List[Tuple[int, int]]] = {}
    for i, (batch_seeds, slot) in enumerate(batches):
        by_batch.setdefault(tuple(batch_seeds), []).append((i, slot))
    for batch_seeds, members in by_batch.items():
        gen = torch.Generator(device=device).manual_seed(int(batch_seeds[0]))
        for s, (t, tp) in enumerate(zip(ts.tolist(), prev.tolist())):
            x = torch.tensor([[t, tp]], dtype=torch.float32, device=device) * pol["input_scale"]
            p = policy_probs(Wp, x, adims, nact, pol["temperature"])[0]
            q = torch.empty((len(batch_seeds), adims, nact), device=device)
            q.exponential_(1, generator=gen)
            for i, slot in members:
                idx = (p / q[slot]).argmax(dim=-1)
                actions[i, s] = grid[torch.arange(adims, device=device), idx]

    out = []
    for lo in range(0, len(prompts), CHUNK):
        sl = slice(lo, lo + CHUNK)
        n = len(prompts[sl])
        ids = torch.as_tensor(hash_ids(prompts[sl], 77, cfg["text_encoder"]["vocab_size"]),
                              device=device)
        empty = torch.as_tensor(hash_ids([""] * n, 77, cfg["text_encoder"]["vocab_size"]),
                                device=device)
        ctx = torch.cat([clip_text(Wt, cfg["text_encoder"], empty),
                         clip_text(Wt, cfg["text_encoder"], ids)])
        x = seed_noise(seeds[sl], (latent, latent, c_in)).to(device).permute(0, 3, 1, 2)
        hist: List[torch.Tensor] = []
        for s, (t, tp) in enumerate(zip(ts.tolist(), prev.tolist())):
            tt = torch.full((2 * n,), t, dtype=torch.int64, device=device)
            e_u, e_c = unet(Wu, cfg["unet"], torch.cat([x, x]), tt, ctx).chunk(2)
            eps = e_u + scale * (e_c - e_u)
            hist = [eps] + hist[:order - 1]
            raw = actions[sl, s, :order - 1]
            coeffs = lmm_coefficients(raw, len(hist), order)
            eff = sum(coeffs[:, j, None, None, None] * hist[j] for j in range(len(hist)))
            a_t = alphas[t]
            a_p = alphas[tp] if tp >= 0 else alphas[0]
            x0 = (x - (1 - a_t) ** 0.5 * eff) / a_t ** 0.5
            x = a_p ** 0.5 * x0 + (1 - a_p) ** 0.5 * eff
        img = vae_decode(Wv, cfg["vae"], x / cfg["vae"]["scaling_factor"])
        out.append(to_uint8((img / 2 + 0.5).permute(0, 2, 3, 1)))
    return np.concatenate(out)


def _action_grid(pol: dict, device) -> torch.Tensor:
    """``[action_dims, num_actions]`` action values of the SD family: first
    order ``linspace(0, 2)``, second ``linspace(-2, 0)``, higher orders
    ``linspace(-1, 1)``."""
    n, order = pol["num_actions"], pol["order_dim"]
    rows = []
    for i in range(order - 1 + pol["scaler_dim"]):
        if i == 0:
            rows.append(np.linspace(0, pol["first_order_max"], n))
        elif i == 1 and i < order - 1:
            rows.append(np.linspace(-2, 0, n))
        elif i < order - 1:
            rows.append(np.linspace(-1, 1, n))
        else:
            rows.append(np.linspace(-0.05, 0.05, n))
    return torch.as_tensor(np.stack(rows).astype(np.float32), device=device)
