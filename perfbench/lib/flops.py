"""Operations and bytes of the work a cell serves, counted from its shapes,
whatever implements them: 2 per multiply-add of every matrix product and
convolution, and 4 * B * H * Sq * Sk * D per attention (its two products).
Norms, activations and the solver's elementwise work are left out.

Peaks: one NVIDIA H100 SXM at its published dense rates (700 W).
"""

from __future__ import annotations

from typing import List, Tuple

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
CLIP_TOKENS = 77  # CLIP's context: the UNet's cross-attention keys

Attn = Tuple[int, int, int, int, int]  # B, H, Sq, Sk, D


def attention_flops(b: int, h: int, sq: int, sk: int, d: int) -> float:
    return 4.0 * b * h * sq * sk * d


def attention_bound_s(call: Attn) -> Tuple[float, str]:
    """The least time of one bf16 attention call on the chip, and what
    bounds it: operations over the peak rate, or q, k, v read and o written
    once (2 bytes an element) over the memory bandwidth."""
    b, h, sq, sk, d = call
    op_s = attention_flops(b, h, sq, sk, d) / BF16_PEAK_FLOPS
    byte_s = (2 * b * sq * h * d + 2 * b * sk * h * d) * 2 / HBM_BYTES_PER_S
    return (op_s, "operations") if op_s >= byte_s else (byte_s, "bytes")


def _conv(rows, hw, cin, cout, k=3):
    return 2.0 * rows * hw * cin * cout * k * k


def _lin(rows, cin, cout):
    return 2.0 * rows * cin * cout


class Count:
    def __init__(self):
        self.flops = 0.0
        self.attn: List[Attn] = []

    def attention(self, b, h, sq, sk, d):
        self.flops += attention_flops(b, h, sq, sk, d)
        self.attn.append((b, h, sq, sk, d))


# ------------------------------------------------------------------ SD
def _resnet(c: Count, rows, hw, cin, cout, temb):
    c.flops += _conv(rows, hw, cin, cout) + _conv(rows, hw, cout, cout)
    if temb:
        c.flops += _lin(rows, temb, cout)
    if cin != cout:
        c.flops += _conv(rows, hw, cin, cout, 1)


def _transformer(c: Count, rows, hw, ch, heads, ctx_len, ctx_dim):
    c.flops += 2 * _conv(rows, hw, ch, ch, 1)  # proj_in, proj_out
    c.flops += 4 * _lin(rows * hw, ch, ch)  # self q, k, v, out
    c.attention(rows, heads, hw, hw, ch // heads)
    c.flops += 2 * _lin(rows * hw, ch, ch) + 2 * _lin(rows * ctx_len, ctx_dim, ch)
    c.attention(rows, heads, hw, ctx_len, ch // heads)
    c.flops += _lin(rows * hw, ch, 8 * ch) + _lin(rows * hw, 4 * ch, ch)  # GEGLU, out


def unet(cfg: dict, rows: int, latent: int) -> Count:
    c, ctx_len = Count(), CLIP_TOKENS
    ch, layers, attn = cfg["block_out_channels"], cfg["layers_per_block"], cfg["cross_attn_blocks"]
    heads, ctx_dim, temb = cfg["attention_head_dim"], cfg["cross_attention_dim"], 4 * ch[0]
    c.flops += _lin(rows, ch[0], temb) + _lin(rows, temb, temb)
    hw = latent * latent
    c.flops += _conv(rows, hw, cfg["in_channels"], ch[0])
    skips, prev = [ch[0]], ch[0]
    for i, out in enumerate(ch):
        for j in range(layers):
            _resnet(c, rows, hw, prev if j == 0 else out, out, temb)
            if attn[i]:
                _transformer(c, rows, hw, out, heads, ctx_len, ctx_dim)
            skips.append(out)
        prev = out
        if i < len(ch) - 1:
            hw //= 4
            c.flops += _conv(rows, hw, out, out)
            skips.append(out)
    _resnet(c, rows, hw, prev, prev, temb)
    _transformer(c, rows, hw, prev, heads, ctx_len, ctx_dim)
    _resnet(c, rows, hw, prev, prev, temb)
    for i, out in enumerate(reversed(ch)):
        level = len(ch) - 1 - i
        for j in range(layers + 1):
            _resnet(c, rows, hw, prev + skips.pop(), out, temb)
            prev = out
            if attn[level]:
                _transformer(c, rows, hw, out, heads, ctx_len, ctx_dim)
        if i < len(ch) - 1:
            hw *= 4
            c.flops += _conv(rows, hw, out, out)
    c.flops += _conv(rows, hw, ch[0], cfg["out_channels"])
    return c


def _vae_mid(c: Count, rows, hw, ch):
    _resnet(c, rows, hw, ch, ch, 0)
    c.flops += 4 * _lin(rows * hw, ch, ch)
    c.attention(rows, 1, hw, hw, ch)
    _resnet(c, rows, hw, ch, ch, 0)


def vae_decode(cfg: dict, rows: int, latent: int) -> Count:
    c = Count()
    rev, layers = list(reversed(cfg["block_out_channels"])), cfg["layers_per_block"]
    hw = latent * latent
    zc = cfg["latent_channels"]
    c.flops += _conv(rows, hw, zc, zc, 1) + _conv(rows, hw, zc, rev[0])
    _vae_mid(c, rows, hw, rev[0])
    prev = rev[0]
    for i, out in enumerate(rev):
        for j in range(layers + 1):
            _resnet(c, rows, hw, prev if j == 0 else out, out, 0)
        prev = out
        if i < len(rev) - 1:
            hw *= 4
            c.flops += _conv(rows, hw, out, out)
    c.flops += _conv(rows, hw, rev[-1], cfg["out_channels"])
    return c


def vae_encode(cfg: dict, rows: int, size: int) -> Count:
    c = Count()
    ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
    hw = size * size
    c.flops += _conv(rows, hw, cfg["in_channels"], ch[0])
    prev = ch[0]
    for i, out in enumerate(ch):
        for j in range(layers):
            _resnet(c, rows, hw, prev if j == 0 else out, out, 0)
        prev = out
        if i < len(ch) - 1:
            hw //= 4
            c.flops += _conv(rows, hw, out, out)
    _vae_mid(c, rows, hw, prev)
    zc2 = 2 * cfg["latent_channels"]
    c.flops += _conv(rows, hw, prev, zc2) + _conv(rows, hw, zc2, zc2, 1)
    return c


def clip_text(cfg: dict, rows: int) -> Count:
    """CLIP's causal attention takes the plain path; its products count."""
    c, seq = Count(), CLIP_TOKENS
    h, ff = cfg["hidden_size"], cfg["intermediate_size"]
    per = 4 * _lin(rows * seq, h, h) + 2 * _lin(rows * seq, h, ff)
    c.flops += cfg["num_layers"] * (per + attention_flops(rows, cfg["num_heads"], seq, seq,
                                                           h // cfg["num_heads"]))
    return c


# ---------------------------------------------------------------- FLUX
def t5(cfg: dict, rows: int, seq: int) -> Count:
    c = Count()
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    per = 4 * _lin(rows * seq, d, inner) + 3 * _lin(rows * seq, d, ff)
    c.flops += cfg["num_layers"] * (per + attention_flops(rows, cfg["num_heads"], seq, seq,
                                                           cfg["d_kv"]))
    return c


def dit(cfg: dict, rows: int, img_tokens: int, txt_tokens: int) -> Count:
    """One DiT forward over ``img_tokens`` image tokens (target and
    reference) and ``txt_tokens`` T5 tokens."""
    c = Count()
    h, heads = cfg["hidden_size"], cfg["num_heads"]
    mlp, d, s = int(h * cfg["mlp_ratio"]), h // heads, img_tokens + txt_tokens
    c.flops += _lin(rows * img_tokens, cfg["in_channels"], h)
    c.flops += _lin(rows * txt_tokens, cfg["joint_text_dim"], h)
    c.flops += 2 * (_lin(rows, 256, h) + _lin(rows, h, h))  # timestep, guidance
    c.flops += _lin(rows, cfg["pooled_text_dim"], h) + _lin(rows, h, h)
    for _ in range(cfg["num_double_blocks"]):
        c.flops += 2 * _lin(rows, h, 6 * h)
        for n in (img_tokens, txt_tokens):
            c.flops += 4 * _lin(rows * n, h, h) + _lin(rows * n, h, mlp) + _lin(rows * n, mlp, h)
        c.attention(rows, heads, s, s, d)
    for _ in range(cfg["num_single_blocks"]):
        c.flops += _lin(rows, h, 3 * h) + 3 * _lin(rows * s, h, h)
        c.flops += _lin(rows * s, h, mlp) + _lin(rows * s, h + mlp, h)
        c.attention(rows, heads, s, s, d)
    c.flops += _lin(rows, h, 2 * h) + _lin(rows * img_tokens, h, cfg["in_channels"])
    return c

