"""Tiny stacks of the benchmark's configurations, for the CPU tests: the
cells' own traffic files and harness, with every model cut to a few
channels."""

from __future__ import annotations

import copy

from perfbench import run


def bench():
    return run.load_json(run.ROOT / "BENCHMARK.json")


def cell(name: str):
    """(workload, configuration) of a cell, the configuration cut to tiny
    widths and given limits that a tiny f32 run on the CPU keeps."""
    wl = copy.deepcopy(run.load_json(run.BENCH_DIR / "workloads" / f"{name}.json"))
    cfg = copy.deepcopy(run.load_json(run.BENCH_DIR / "configs" / f"{wl['config']}.json"))
    if wl["config"] == "sd15-preview":
        cfg["unet"].update(block_out_channels=[32, 64], layers_per_block=1,
                           cross_attn_blocks=[True, False], attention_head_dim=2,
                           cross_attention_dim=32, norm_num_groups=8)
        cfg["text_encoder"].update(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                                   intermediate_size=64)
        cfg["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=4)
        cfg["pipeline"]["resolution"] = 64
    else:
        cfg["transformer"].update(in_channels=16, hidden_size=48, num_heads=2,
                                  num_double_blocks=2, num_single_blocks=2, joint_text_dim=32,
                                  pooled_text_dim=24, axes_dims=[8, 8, 8])
        cfg["t5"].update(vocab_size=512, d_model=32, d_kv=8, d_ff=64, num_layers=1, num_heads=4)
        cfg["clip"].update(vocab_size=1000, hidden_size=24, num_layers=1, num_heads=2,
                           intermediate_size=32)
        cfg["vae"].update(block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4,
                          latent_channels=4)
        cfg["pipeline"].update(resolution=32, t5_max_length=16)
        wl["traffic"]["source_sizes"] = [[40, 24], [24, 40], [32, 32]]
    if "check_within" in wl["traffic"]:  # what a 2 s window on the CPU completes
        wl["traffic"]["check_within"] = 3
    if "rate_rps" in wl["traffic"]:
        wl["traffic"]["rate_rps"] = 3.0
    wl["traffic"]["check_sample"] = min(wl["traffic"]["check_sample"], 3)
    wl["traffic"]["grace_s"] = 120.0
    wl["trace"] = {"start_s": 0.5, "seconds": 1.0, "margin_s": 0.2}
    # a tiny f32 stack on the CPU reads 0.15-0.2 levels mean and no channel
    # 8 levels off; a planted fault reads 0.5 % of channels or more
    cfg["check"]["limits"] = {"img_mae_max": 0.5, "px_off8_pct_max": 0.1, "px_off16_pct_max": 0.1}
    return wl, cfg
