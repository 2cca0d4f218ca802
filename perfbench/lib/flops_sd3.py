"""Operations of SD3's models, counted from their shapes as
``perfbench/lib/flops.py`` counts the others: 2 per multiply-add of every
matrix product, and 4 * B * H * Sq * Sk * D per attention."""

from __future__ import annotations

from perfbench.lib.flops import Count, _lin, clip_text


def mmdit(cfg: dict, rows: int, img_tokens: int, txt_tokens: int) -> Count:
    """One MMDiT forward over ``img_tokens`` 2x2 patches and ``txt_tokens``
    context tokens: the patch embedding, the context embedding, the
    timestep and pooled-text MLPs, ``num_layers`` joint blocks (the last
    one's text stream only projects q, k and v from a 2-way modulation), the
    final modulation and ``proj_out``."""
    c = Count()
    h, heads, p = cfg["hidden_size"], cfg["num_heads"], cfg["patch_size"]
    mlp, s = int(h * cfg["mlp_ratio"]), img_tokens + txt_tokens
    c.flops += _lin(rows * img_tokens, cfg["in_channels"] * p * p, h)
    c.flops += _lin(rows * txt_tokens, cfg["joint_attention_dim"], h)
    c.flops += _lin(rows, 256, h) + _lin(rows, cfg["pooled_projection_dim"], h)
    c.flops += 2 * _lin(rows, h, h)
    for i in range(cfg["num_layers"]):
        last = i == cfg["num_layers"] - 1
        c.flops += _lin(rows, h, 6 * h) + _lin(rows, h, (2 if last else 6) * h)
        n = rows * img_tokens
        c.flops += 4 * _lin(n, h, h) + _lin(n, h, mlp) + _lin(n, mlp, h)
        n = rows * txt_tokens
        c.flops += 3 * _lin(n, h, h)
        if not last:
            c.flops += _lin(n, h, h) + _lin(n, h, mlp) + _lin(n, mlp, h)
        c.attention(rows, heads, s, s, h // heads)
    c.flops += _lin(rows, h, 2 * h) + _lin(rows * img_tokens, h, p * p * cfg["out_channels"])
    return c


def clip_text_proj(cfg: dict, rows: int) -> Count:
    """A CLIP text tower over its 77 tokens, and its ``text_projection`` of
    the pooled state."""
    c = clip_text(cfg, rows)
    c.flops += _lin(rows, cfg["hidden_size"], cfg["projection_dim"])
    return c
