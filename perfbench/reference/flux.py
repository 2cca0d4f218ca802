"""Plain float32 reference of a FLUX.1-Kontext edit: T5-v1.1-XXL, CLIP-L
pooled, the 16-channel VAE, the rectified-flow DiT (double- and
single-stream blocks, 3-axis RoPE, adaLN modulation, guidance embedding) and
the learnable flow-matching solver, from the published FLUX design
(``black-forest-labs/FLUX.1-Kontext-dev`` ``transformer/config.json``) and
the T5 v1.1 paper.

Departures from diffusers, each the served deployment's stated numerics:
T5 attends to every one of its 128 positions (the deployment passes no
padding mask); the VAE keeps the 1x1 quant convolutions of the SD VAE
(FLUX's published VAE has none); tanh GELUs; RoPE rotates interleaved pairs;
the final modulation splits as (scale, shift).

Weight names are the served DiT's (``transformer_blocks.0.attn_to_q``);
the DiT's weights are drawn block by block.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    attention, center_crop_resize, gelu_tanh, hash_ids, linear, lmm_coefficients, policy_probs,
    seed_noise, timestep_embedding, to_uint8,
)
from perfbench.reference import sd15
from perfbench.reference.sd15 import clip_text

HEADS_PER_CHUNK = 4


# -------------------------------------------------------------------- T5
def t5_buckets(s: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional relative-position buckets ``[s, s]``."""
    rel = np.arange(s)[None, :] - np.arange(s)[:, None]
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(n, 1) / exact) / math.log(max_distance / exact)
                     * (nb - exact)).astype(np.int64)
    return ret + np.where(n < exact, n, np.minimum(large, nb - 1))


def _rms(W, name, x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * W(name)


def t5_encode(W, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    b, s = ids.shape
    heads, dkv = cfg["num_heads"], cfg["d_kv"]
    x = W("shared.weight")[ids]
    buckets = torch.as_tensor(t5_buckets(s, cfg["relative_attention_num_buckets"],
                                         cfg["relative_attention_max_distance"]), device=ids.device)
    bias = W("relative_attention_bias.weight")[buckets].permute(2, 0, 1)[None]
    for i in range(cfg["num_layers"]):
        p = f"block.{i}"
        h = _rms(W, f"{p}.ln_attn.weight", x)
        q, k, v = (F.linear(h, W(f"{p}.attention.{n}.weight")).reshape(b, s, heads, dkv)
                   for n in "qkv")
        # T5 attention is unscaled: q * sqrt(d) undoes attention's 1/sqrt(d)
        a = attention(q * dkv ** 0.5, k, v, bias=bias).reshape(b, s, heads * dkv)
        x = x + F.linear(a, W(f"{p}.attention.o.weight"))
        h = _rms(W, f"{p}.ln_ff.weight", x)
        ff = gelu_tanh(F.linear(h, W(f"{p}.wi_0.weight"))) * F.linear(h, W(f"{p}.wi_1.weight"))
        x = x + F.linear(ff, W(f"{p}.wo.weight"))
    return _rms(W, "final_layer_norm.weight", x)


# ------------------------------------------------------------------- DiT
def _ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _qk_norm(W, name, x):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * W(name)


def rope(ids: torch.Tensor, axes: Sequence[int], theta: int):
    cos, sin = [], []
    for axis, dim in enumerate(axes):
        omega = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim)
        ang = ids[:, axis:axis + 1] * omega[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def _rotate(x, cos, sin):
    b, s, h, d = x.shape
    x = x.reshape(b, s, h, d // 2, 2)
    x0, x1 = x[..., 0], x[..., 1]
    c, si = cos[None, :, None], sin[None, :, None]
    return torch.stack([x0 * c - x1 * si, x0 * si + x1 * c], -1).reshape(b, s, h, d)


def _mod(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def dit(W, cfg: dict, img, txt, pooled, t, guidance, img_ids, txt_ids):
    """velocity of the image tokens (target and reference) ``[B, S_img, C]``."""
    h, heads = cfg["hidden_size"], cfg["num_heads"]
    hd = h // heads
    img = linear(W, "x_embedder", img)
    txt = linear(W, "context_embedder", txt)

    def mlp(p, x):
        return linear(W, f"{p}.linear_2", F.silu(linear(W, f"{p}.linear_1", x)))

    vec = mlp("timestep_embedder", timestep_embedding(t, 256))
    vec = vec + mlp("guidance_embedder", timestep_embedding(guidance * 1000.0, 256))
    vec = vec + mlp("text_embedder", pooled)
    cos, sin = rope(torch.cat([txt_ids, img_ids]), cfg["axes_dims"], cfg["theta"])
    b, st = img.shape[0], txt.shape[1]

    def heads_of(x):
        return x.reshape(b, x.shape[1], heads, hd)

    for i in range(cfg["num_double_blocks"]):
        p = f"transformer_blocks.{i}"
        im = linear(W, f"{p}.norm1_linear", F.silu(vec)).chunk(6, -1)
        tm = linear(W, f"{p}.norm1_context_linear", F.silu(vec)).chunk(6, -1)
        img_n, txt_n = _mod(_ln(img), im[0], im[1]), _mod(_ln(txt), tm[0], tm[1])
        q = torch.cat([_qk_norm(W, f"{p}.attn_norm_added_q.weight", heads_of(linear(W, f"{p}.attn_add_q", txt_n))),
                       _qk_norm(W, f"{p}.attn_norm_q.weight", heads_of(linear(W, f"{p}.attn_to_q", img_n)))], 1)
        k = torch.cat([_qk_norm(W, f"{p}.attn_norm_added_k.weight", heads_of(linear(W, f"{p}.attn_add_k", txt_n))),
                       _qk_norm(W, f"{p}.attn_norm_k.weight", heads_of(linear(W, f"{p}.attn_to_k", img_n)))], 1)
        v = torch.cat([heads_of(linear(W, f"{p}.attn_add_v", txt_n)),
                       heads_of(linear(W, f"{p}.attn_to_v", img_n))], 1)
        a = attention(_rotate(q, cos, sin), _rotate(k, cos, sin), v,
                      heads_per_chunk=HEADS_PER_CHUNK).reshape(b, q.shape[1], h)
        img = img + im[2][:, None] * linear(W, f"{p}.attn_to_out_0", a[:, st:])
        txt = txt + tm[2][:, None] * linear(W, f"{p}.attn_to_add_out", a[:, :st])
        img_m, txt_m = _mod(_ln(img), im[3], im[4]), _mod(_ln(txt), tm[3], tm[4])
        img = img + im[5][:, None] * linear(W, f"{p}.ff_net_2", gelu_tanh(linear(W, f"{p}.ff_net_0_proj", img_m)))
        txt = txt + tm[5][:, None] * linear(W, f"{p}.ff_context_net_2",
                                            gelu_tanh(linear(W, f"{p}.ff_context_net_0_proj", txt_m)))
    x = torch.cat([txt, img], 1)
    for i in range(cfg["num_single_blocks"]):
        p = f"single_transformer_blocks.{i}"
        shift, scale, gate = linear(W, f"{p}.norm_linear", F.silu(vec)).chunk(3, -1)
        xn = _mod(_ln(x), shift, scale)
        q = _qk_norm(W, f"{p}.attn_norm_q.weight", heads_of(linear(W, f"{p}.attn_to_q", xn)))
        k = _qk_norm(W, f"{p}.attn_norm_k.weight", heads_of(linear(W, f"{p}.attn_to_k", xn)))
        v = heads_of(linear(W, f"{p}.attn_to_v", xn))
        a = attention(_rotate(q, cos, sin), _rotate(k, cos, sin), v,
                      heads_per_chunk=HEADS_PER_CHUNK).reshape(b, x.shape[1], h)
        m = gelu_tanh(linear(W, f"{p}.proj_mlp", xn))
        x = x + gate[:, None] * linear(W, f"{p}.proj_out", torch.cat([a, m], -1))
    x = x[:, st:]
    scale, shift = linear(W, "norm_out_linear", F.silu(vec)).chunk(2, -1)
    return linear(W, "proj_out", _mod(_ln(x), shift, scale))


# --------------------------------------------------------------- helpers
def pack(lat: torch.Tensor) -> torch.Tensor:
    """NHWC latents -> 2x2 patches ``[B, HW/4, 4C]``, channel-major."""
    b, hh, ww, c = lat.shape
    x = lat.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (hh // 2) * (ww // 2), 4 * c)


def unpack(x: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    b, _, c4 = x.shape
    x = x.reshape(b, hh // 2, ww // 2, c4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, hh, ww, c4 // 4)


def image_ids(hh: int, ww: int, offset: float, device) -> torch.Tensor:
    h, w = hh // 2, ww // 2
    ids = torch.zeros((h, w, 3), device=device)
    ids[..., 0] = offset
    ids[..., 1] += torch.arange(h, device=device, dtype=torch.float32)[:, None]
    ids[..., 2] += torch.arange(w, device=device, dtype=torch.float32)[None]
    return ids.reshape(h * w, 3)


def fm_ladder(fm: dict, steps: int, image_seq_len: int):
    """FLUX's shifted sigma ladder (float32, terminal 0 appended) and the
    timesteps ``sigma * 1000``."""
    m = (fm["max_shift"] - fm["base_shift"]) / (fm["max_image_seq_len"] - fm["base_image_seq_len"])
    mu = image_seq_len * m + fm["base_shift"] - m * fm["base_image_seq_len"]
    n = fm["num_train_timesteps"]
    sig = np.linspace(n, 1, steps) / n
    sig = (math.exp(mu) / (math.exp(mu) + (1 / sig - 1))).astype(np.float32)
    return np.concatenate([sig, np.zeros(1, np.float32)]), (sig * n).astype(np.float32)


def _fm_grid(pol: dict, device) -> torch.Tensor:
    n = pol["num_actions"]
    rows = [np.linspace(0, pol["first_order_max"], n)]
    for i in range(1, pol["order_dim"] - 1 + pol["scaler_dim"]):
        rows.append(np.linspace(-2, 0, n) if i == 1 and i < pol["order_dim"] - 1 else
                    np.linspace(-1, 1, n) if i < pol["order_dim"] - 1 else
                    np.linspace(-0.05, 0.05, n))
    return torch.as_tensor(np.stack(rows).astype(np.float32), device=device)


# ------------------------------------------------------------------ edit
def edits(weights: Dict[str, object], cfg: dict, instructions: Sequence[str],
          sources: Sequence[np.ndarray], seeds: Sequence[int], batches, device) -> np.ndarray:
    """Served edits, worked out again, one at a time: uint8 ``[N, R, R, 3]``.
    ``batches[i]`` = (the padded seed list of request ``i``'s batch, its
    slot); the policy samples as in :func:`perfbench.reference.sd15.previews`."""
    pipe, pol = cfg["pipeline"], cfg["factor_net"]
    res, steps = pipe["resolution"], pipe["num_inference_steps"]
    lat = res // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    adims = pol["order_dim"] + pol["scaler_dim"] - 1
    grid = _fm_grid(pol, device)
    sig, ts = fm_ladder(cfg["flow_match"], steps, (lat // 2) ** 2)
    vae_cfg, tcfg = cfg["vae"], cfg["transformer"]
    out: List[np.ndarray] = []
    for i, (text, src, seed) in enumerate(zip(instructions, sources, seeds)):
        t5_vocab = cfg["t5"]["vocab_size"]
        t5_ids = torch.as_tensor(hash_ids([text], pipe["t5_max_length"], t5_vocab,
                                          hash_vocab=t5_vocab), device=device)
        clip_ids = torch.as_tensor(hash_ids([text], 77, cfg["clip"]["vocab_size"]), device=device)
        prompt = t5_encode(weights["t5"], cfg["t5"], t5_ids)
        hidden = clip_text(weights["clip"], cfg["clip"], clip_ids)
        pooled = hidden[torch.arange(1, device=device), clip_ids.argmax(-1)]
        ref = torch.as_tensor(center_crop_resize(src, res), device=device)[None] * 2.0 - 1.0
        mean = sd15.vae_encode_mean(weights["vae"], vae_cfg, ref.permute(0, 3, 1, 2))
        ref_tokens = pack(((mean - pipe["vae_shift_factor"]) * vae_cfg["scaling_factor"])
                          .permute(0, 2, 3, 1))
        x = pack(seed_noise([seed], (lat, lat, vae_cfg["latent_channels"])).to(device))
        img_ids = torch.cat([image_ids(lat, lat, 0.0, device), image_ids(lat, lat, 1.0, device)])
        txt_ids = torch.zeros((t5_ids.shape[1], 3), device=device)
        batch_seeds, slot = batches[i]
        gen = torch.Generator(device=device).manual_seed(int(batch_seeds[0]))
        hist: List[torch.Tensor] = []
        for s in range(steps):
            tt = torch.full((1,), float(ts[s]), device=device)
            g = torch.full((1,), float(pipe["guidance_scale"]), device=device)
            v = dit(weights["transformer"], tcfg, torch.cat([x, ref_tokens], 1), prompt, pooled,
                    tt, g, img_ids, txt_ids)[:, :x.shape[1]]
            hist = [v] + hist[:pol["order_dim"] - 1]
            cond = torch.tensor([[sig[s], sig[s + 1]]], device=device) * pol["input_scale"]
            p = policy_probs(weights["factor_net"], cond, adims, pol["num_actions"],
                             pol["temperature"])[0]
            q = torch.empty((len(batch_seeds), adims, pol["num_actions"]), device=device)
            q.exponential_(1, generator=gen)
            act = grid[torch.arange(adims, device=device), (p / q[slot]).argmax(-1)]
            coeffs = lmm_coefficients(act[None, :pol["order_dim"] - 1], len(hist), pol["order_dim"])
            eff = sum(coeffs[:, j, None, None] * hist[j] for j in range(len(hist)))
            x = x + float(np.float32(sig[s + 1]) - np.float32(sig[s])) * eff
        z = unpack(x, lat, lat) / vae_cfg["scaling_factor"] + pipe["vae_shift_factor"]
        img = sd15.vae_decode(weights["vae"], vae_cfg, z.permute(0, 3, 1, 2))
        out.append(to_uint8((img / 2 + 0.5).permute(0, 2, 3, 1)))
    return np.concatenate(out)
