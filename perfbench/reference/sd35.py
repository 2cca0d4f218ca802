"""Plain float32 reference of a Stable Diffusion 3.5 Large preview: CLIP-L
and OpenCLIP bigG/14 with their projections, T5-v1.1-XXL, the context
assembly, the MMDiT (38 joint blocks, the last ``context_pre_only``), the
flow-matching ladder with shift 3.0, classifier-free guidance, the learnable
FMPPO update with the policy's sampled actions, and the 16-channel VAE
decode, from the published SD3 design (``stabilityai/stable-diffusion-3.5-large``
``transformer/``, ``scheduler/`` and ``text_encoder{,_2,_3}/config.json``;
arXiv:2403.03206; diffusers' ``SD3Transformer2DModel``,
``StableDiffusion3Pipeline`` and ``FlowMatchEulerDiscreteScheduler``).

Departures from diffusers, each the served deployment's stated numerics:
the CLIP towers pool the state of the largest token id (the deployment's
hash tokenizer puts EOS = 2 below the word ids; transformers takes the
argmax for its legacy EOS id 2); T5 attends to every one of its 256
positions (no padding mask); the VAE keeps the 1x1 quant convolutions of the
SD VAE (SD3's published VAE has none); the joint attention is computed over
[image | text] as diffusers orders it, which the served program's [text |
image] order does not change.

Weight names are the served modules' (``transformer_blocks.0.attn_to_q``,
``pos_embed_proj``); every weight group (a block, a layer) is drawn from the
seed on first use, in the served dtype, and read as f32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import flux, sd15
from perfbench.reference.common import (
    attention, gelu_tanh, hash_ids, layer_norm, linear, lmm_coefficients, policy_probs,
    seed_noise, timestep_embedding, to_uint8,
)

HEADS_PER_CHUNK = 8  # [2, 8, 4429, 4429] f32 scores: 1.3 GB


# ------------------------------------------------------------------ CLIP
def clip_tower(W, cfg: dict, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids ``[B, S]`` -> (the residual stream entering the last layer, i.e.
    ``hidden_states[-2]``, ``[B, S, C]``; the final-LayerNorm state at the
    pooled token through the bias-free ``text_projection``, ``[B, P]``).
    Causal self-attention, pre-norm, quick-GELU or exact GELU."""
    s = ids.shape[1]
    x = W("token_embedding.weight")[ids] + W("position_embedding.weight")[:s][None]
    heads = cfg["num_heads"]
    act = F.gelu if cfg["hidden_act"] == "gelu" else (lambda h: h * torch.sigmoid(1.702 * h))
    for i in range(cfg["num_layers"]):
        penultimate = x
        p = f"layers.{i}"
        h = layer_norm(W, f"{p}.layer_norm1", x, 1e-5)
        b, _, c = h.shape
        q, k, v = (linear(W, f"{p}.self_attn.{n}_proj", h).reshape(b, s, heads, c // heads)
                   for n in "qkv")
        x = x + linear(W, f"{p}.self_attn.out_proj", attention(q, k, v, causal=True).reshape(b, s, c))
        h = linear(W, f"{p}.mlp_fc1", layer_norm(W, f"{p}.layer_norm2", x, 1e-5))
        x = x + linear(W, f"{p}.mlp_fc2", act(h))
    x = layer_norm(W, "final_layer_norm", x, 1e-5)
    pooled = x[torch.arange(ids.shape[0], device=ids.device), ids.argmax(-1)]
    return penultimate, F.linear(pooled, W("text_projection.weight"))


def encode(weights, cfg: dict, texts: Sequence[str], device):
    """(context ``[B, 77 + S_t5, 4096]``, pooled ``[B, 2048]``) of the
    texts: the CLIP towers' states side by side, zero-padded to T5's width,
    then T5's states; the projected pooled states side by side."""
    t5_len, t5_vocab = cfg["pipeline"]["t5_max_length"], cfg["t5"]["vocab_size"]
    hidden, pooled = [], []
    for tag in ("clip_l", "clip_g"):
        ids = torch.as_tensor(hash_ids(texts, 77, cfg[tag]["vocab_size"]), device=device)
        h, p = clip_tower(weights[tag], cfg[tag], ids)
        hidden.append(h)
        pooled.append(p)
    t5_ids = torch.as_tensor(hash_ids(texts, t5_len, t5_vocab, hash_vocab=t5_vocab), device=device)
    t5 = flux.t5_encode(weights["t5"], cfg["t5"], t5_ids)
    clip = torch.cat(hidden, -1)
    clip = F.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
    return torch.cat([clip, t5], 1), torch.cat(pooled, -1)


# ----------------------------------------------------------------- MMDiT
def pos_table(cfg: dict, h: int, w: int, device) -> torch.Tensor:
    """The centre ``h x w`` crop of the 2-D sin-cos table over
    ``pos_embed_max_size``² positions at ``base_size = sample_size /
    patch_size``: ``[h * w, hidden]``, columns' code then rows'."""
    m, dim = cfg["pos_embed_max_size"], cfg["hidden_size"]
    base = cfg["sample_size"] // cfg["patch_size"]
    top, left = (m - h) // 2, (m - w) // 2
    rows = (torch.arange(top, top + h, dtype=torch.float64) / (m / base))[:, None].expand(h, w)
    cols = (torch.arange(left, left + w, dtype=torch.float64) / (m / base))[None, :].expand(h, w)
    omega = 1.0 / 10000 ** (torch.arange(dim // 4, dtype=torch.float64) / (dim / 4))

    def code(pos):
        out = pos.reshape(-1, 1) * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], 1)

    return torch.cat([code(cols), code(rows)], 1).float().to(device)


def _rms(W, name, x):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * W(name)


def _mod(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def mmdit(W, cfg: dict, latents: torch.Tensor, context, pooled, t) -> torch.Tensor:
    """Velocity NHWC of latents NHWC ``[B, H, W, C]`` at timesteps ``t``
    (sigma * 1000)."""
    b, hh, ww, c = latents.shape
    h, heads, p = cfg["hidden_size"], cfg["num_heads"], cfg["patch_size"]
    hd = h // heads
    img = linear(W, "pos_embed_proj", flux.pack(latents)) + pos_table(cfg, hh // p, ww // p,
                                                                       latents.device)
    txt = linear(W, "context_embedder", context)

    def mlp(name, x):
        return linear(W, f"{name}.linear_2", F.silu(linear(W, f"{name}.linear_1", x)))

    vec = mlp("timestep_embedder", timestep_embedding(t, 256)) + mlp("text_embedder", pooled)
    si = img.shape[1]

    def heads_of(x):
        return x.reshape(b, x.shape[1], heads, hd)

    def ln(x):
        return F.layer_norm(x, (x.shape[-1],), eps=1e-6)

    for i in range(cfg["num_layers"]):
        bp = f"transformer_blocks.{i}"
        last = i == cfg["num_layers"] - 1
        im = linear(W, f"{bp}.norm1_linear", F.silu(vec)).chunk(6, -1)
        if last:  # AdaLayerNormContinuous: (scale, shift)
            scale, shift = linear(W, f"{bp}.norm1_context_linear", F.silu(vec)).chunk(2, -1)
            txt_n = _mod(ln(txt), shift, scale)
        else:
            tm = linear(W, f"{bp}.norm1_context_linear", F.silu(vec)).chunk(6, -1)
            txt_n = _mod(ln(txt), tm[0], tm[1])
        img_n = _mod(ln(img), im[0], im[1])
        q = torch.cat([_rms(W, f"{bp}.attn_norm_q.weight", heads_of(linear(W, f"{bp}.attn_to_q", img_n))),
                       _rms(W, f"{bp}.attn_norm_added_q.weight", heads_of(linear(W, f"{bp}.attn_add_q", txt_n)))], 1)
        k = torch.cat([_rms(W, f"{bp}.attn_norm_k.weight", heads_of(linear(W, f"{bp}.attn_to_k", img_n))),
                       _rms(W, f"{bp}.attn_norm_added_k.weight", heads_of(linear(W, f"{bp}.attn_add_k", txt_n)))], 1)
        v = torch.cat([heads_of(linear(W, f"{bp}.attn_to_v", img_n)),
                       heads_of(linear(W, f"{bp}.attn_add_v", txt_n))], 1)
        a = attention(q, k, v, heads_per_chunk=HEADS_PER_CHUNK).reshape(b, q.shape[1], h)
        del q, k, v
        img = img + im[2][:, None] * linear(W, f"{bp}.attn_to_out_0", a[:, :si])
        img_m = _mod(ln(img), im[3], im[4])
        img = img + im[5][:, None] * linear(W, f"{bp}.ff_net_2",
                                            gelu_tanh(linear(W, f"{bp}.ff_net_0_proj", img_m)))
        if not last:
            txt = txt + tm[2][:, None] * linear(W, f"{bp}.attn_to_add_out", a[:, si:])
            txt_m = _mod(ln(txt), tm[3], tm[4])
            txt = txt + tm[5][:, None] * linear(W, f"{bp}.ff_context_net_2",
                                                gelu_tanh(linear(W, f"{bp}.ff_context_net_0_proj", txt_m)))
    scale, shift = linear(W, "norm_out_linear", F.silu(vec)).chunk(2, -1)
    out = linear(W, "proj_out", _mod(ln(img), shift, scale))  # per patch: (row, column, channel)
    out = out.reshape(b, hh // p, ww // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hh, ww, c)


# -------------------------------------------------------------- schedule
def sd3_ladder(fm: dict, steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """``FlowMatchEulerDiscreteScheduler(shift)`` without dynamic shifting:
    the training table ``shift s / (1 + (shift - 1) s)`` over ``s = 1000 ...
    1 / 1000`` (float32) gives sigma_max and sigma_min; ``set_timesteps``
    spaces ``steps`` timesteps linearly from ``1000 sigma_max`` to ``1000
    sigma_min``, shifts ``t / 1000`` again, and appends 0.  Returns (sigmas
    ``[steps + 1]``, timesteps ``[steps]``), float32."""
    n, shift = fm["num_train_timesteps"], fm["shift"]
    train = np.linspace(1, n, n, dtype=np.float32)[::-1] / np.float32(n)
    train = np.float32(shift) * train / (1 + (np.float32(shift) - 1) * train)
    t = np.linspace(float(train[0]) * n, float(train[-1]) * n, steps)
    sig = t / n
    sig = (shift * sig / (1 + (shift - 1) * sig)).astype(np.float32)
    return np.concatenate([sig, np.zeros(1, np.float32)]), (sig * n).astype(np.float32)


# -------------------------------------------------------------- previews
def preview_latents(weights: Dict[str, object], cfg: dict, text: str, seed: int, batch,
                    negative, device) -> torch.Tensor:
    """One preview's final latents NHWC ``[1, h, w, C]``: ``batch`` = (the
    padded seed list of its batch, its slot), ``negative`` = the empty
    prompt's (context, pooled).  The policy samples as in
    :func:`perfbench.reference.sd15.previews`: one generator per batch,
    seeded with its first seed, one ``Exp(1)`` draw ``q`` of shape
    ``[batch, action_dims, num_actions]`` a step, and the action
    ``argmax(p / q)`` of the row's slot."""
    pipe, pol = cfg["pipeline"], cfg["factor_net"]
    steps, scale = pipe["num_inference_steps"], pipe["guidance_scale"]
    lat = pipe["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    adims = pol["order_dim"] + pol["scaler_dim"] - 1
    grid = flux._fm_grid(pol, device)
    sig, ts = sd3_ladder(cfg["flow_match"], steps)
    tcfg = cfg["transformer"]
    context, pooled = encode(weights, cfg, [text], device)
    context, pooled = torch.cat([negative[0], context]), torch.cat([negative[1], pooled])
    x = seed_noise([seed], (lat, lat, tcfg["in_channels"])).to(device)
    batch_seeds, slot = batch
    gen = torch.Generator(device=device).manual_seed(int(batch_seeds[0]))
    hist: List[torch.Tensor] = []
    for s in range(steps):
        tt = torch.full((2,), float(ts[s]), device=device)
        v_u, v_c = mmdit(weights["transformer"], tcfg, torch.cat([x, x]), context, pooled,
                         tt).chunk(2)
        hist = [v_u + scale * (v_c - v_u)] + hist[:pol["order_dim"] - 1]
        cond = torch.tensor([[sig[s], sig[s + 1]]], device=device) * pol["input_scale"]
        p = policy_probs(weights["factor_net"], cond, adims, pol["num_actions"],
                         pol["temperature"])[0]
        q = torch.empty((len(batch_seeds), adims, pol["num_actions"]), device=device)
        q.exponential_(1, generator=gen)
        act = grid[torch.arange(adims, device=device), (p / q[slot]).argmax(-1)]
        coeffs = lmm_coefficients(act[None, :pol["order_dim"] - 1], len(hist), pol["order_dim"])
        eff = sum(coeffs[:, j, None, None, None] * hist[j] for j in range(len(hist)))
        x = x + float(np.float32(sig[s + 1]) - np.float32(sig[s])) * eff
    return x


def decode(weights, cfg: dict, latents: torch.Tensor) -> np.ndarray:
    """Latents NHWC -> uint8 images: ``latents / scaling_factor +
    shift_factor`` through the VAE decoder."""
    z = latents / cfg["vae"]["scaling_factor"] + cfg["pipeline"]["vae_shift_factor"]
    img = sd15.vae_decode(weights["vae"], cfg["vae"], z.permute(0, 3, 1, 2))
    return to_uint8((img / 2 + 0.5).permute(0, 2, 3, 1))


def previews(weights: Dict[str, object], cfg: dict, prompts: Sequence[str], seeds: Sequence[int],
             batches, device) -> np.ndarray:
    """Served previews, worked out again one at a time: uint8 ``[N, R, R,
    3]``.  ``batches[i]`` = (the padded seed list of request ``i``'s batch,
    its slot)."""
    negative = encode(weights, cfg, [""], device)
    return np.concatenate([
        decode(weights, cfg, preview_latents(weights, cfg, text, seed, batch, negative, device))
        for text, seed, batch in zip(prompts, seeds, batches)])
