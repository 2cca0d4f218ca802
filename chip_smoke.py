#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``consolver_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository around this file; it exits
non-zero, printing nothing on stdout, without them.  Phases:

1. Build the three kernel libraries from ``consolver_torch/csrc/`` (one
   ``nvcc`` each, all at once); print the card's name and power limit
   (``nvidia-smi``).
2. Report what kernel #1's tensor-core kernels compiled to, for every
   instantiation (design A, B or H, padded head dim, cp.async, TMA or
   element staging): registers and spills from ptxas, the HMMA / HGMMA count in
   ``cuobjdump -sass``, dynamic shared memory and blocks per SM.  Then hold
   kernel #1 (flash attention) against its plain PyTorch version at
   every attention shape of the SD-1.5 preview path (batch 8, so 16 rows
   under CFG) and of the FLUX-Kontext edit (the DiT's joint attention, the
   VAE's 16384-token mid attention) and of the reward / eval backbones
   (head dim 64: DINOv2-base, CLIP-L/14, Depth-Anything-V2-S's 1370 tokens,
   SegFormer-b4's four stages with keys reduced to 256), plus Sq != Sk, a
   ragged length and large scores, in bf16 (route "mma", the design the
   call takes checked against ``launches_by_design``) and f32 (route
   "fma"); print the build report's width-64 instantiations; time the
   kernel, its plain version and ``scaled_dot_product_attention`` (as a
   yardstick only), beside the least time the card could take, with the
   TFLOP/s of the function and the time over SDPA's and over the bound;
   at the widths design H can take, the device time of designs H and A
   (CUDA graphs of 10 calls) per case and, per width, A over H at each
   main-path shape: the measurement behind ``mma_design``'s rule.
3. Report what the tensor-core kernels of #2 / #4 (``bf16_mma_kernel``)
   and of #3 (``int8_mma_kernel``) compiled to (registers and spills from
   ptxas, their HMMA / HGMMA and IMMA / IGMMA counts in ``cuobjdump
   -sass``, shared memory and blocks per SM), then hold kernels #2-#4
   (``flash_bf16``, ``flash_int8``, ``flash_nomask``) against their plain
   versions at the FLUX serving and training shapes, ragged cases and, for
   int8, block_k = 1024, with the same timings (no library call computes
   #3), the route each took ("mma" for bf16 / nomask, "imma" for int8), its
   TFLOP/s (int8: TOP/s) and its time over SDPA's and over the bound.  For
   int8 the wrapper's time splits into ``quant_ms`` (quantization and
   layout, plain torch) and ``kernel_ms`` (the launch alone), and the rate
   and the ratio to the bound come from ``kernel_ms``.
4. Drive the variants' main path, the probe entry point
   ``consolver_torch.probes.flash_variants``, and count their launches.
5. Drive SD-1.5 at full width through ``TextToImagePipeline``: random-normal
   x0.02 bf16 weights from a seeded generator, 8 prompts, 512x512, 8 steps,
   CFG 3.  Check the images and that kernel #1 ran exactly 8 x 32 + 1 = 257
   times, all on the "mma" route (120 design H, 136 A, 1 B); print img/s, peak
   memory and the kernel's share of device time.
6. The tiny SD stack in f32 on the card and on the CPU, TF32 off: latents,
   images and actions, for the per-count and the padded programs.
7. Drive the FLUX-Kontext edit at full width through
   ``FluxKontextPipeline``: the 11.9 B DiT, T5-XXL, CLIP-L and the 16-channel
   VAE in bf16 (random-normal x0.02), one 1024^2 edit, 5 steps, guidance
   2.5.  Check the image and that kernel #1 ran exactly 5 x 57 + 2 = 287
   times, all on the "mma" route (285 design H, 2 B); print s/edit, peak
   memory, the kernel's share of device time and the idle share; keep one
   DiT forward and one deterministic engine edit (512 T5 tokens) as phase
   21's references.
8. The tiny FLUX stack in f32 on the card and on the CPU, TF32 off, as in 6.
9. The int8 and int4 layers of ``kernels/quant.py`` at main-path shapes (the
   UNet's level-1 and level-2 3x3 convolutions, the level-1 downsample and a
   1x1 shortcut at UNet batch 16; FLUX ``ff_net_0`` over 8704 tokens and a
   modulation at batch 1): the int8 GEMM's int32 against the plain
   version's, the layer's output bit-equal to the plain accumulators
   dequantized alike, int4 within one bf16 ulp; each layer's time and its
   parts (activation quantization, im2col, GEMM, dequantization) beside the
   bf16 layer's.
10. SD-1.5 through ``TextToImagePipeline.quantize()``, the hybrid (level 0
   bf16) and uniform int8, at the settings of 5: kernel #1 257 times per
   generation, all "mma"; the int8 GEMM ran; images finite in [0, 1]; their
   mean and max difference from the bf16 images; img/s, peak, bytes.
11. FLUX-Kontext through ``FluxKontextPipeline.quantize(8)`` and
   ``quantize(4)`` with the bf16 pipeline resident: a check edit (287
   launches, all "mma"; difference from the bf16 edit), one timed edit,
   the DiT's bytes and the peak.
12. The tiny quantized f32 stacks (UNet hybrid and uniform, VAE decoder,
   FLUX int8 and int4), quantized on the CPU and run on the card: every
   quantized layer fed its CPU twin's input within 1e-6 (int4 1e-5), the
   whole output nearer the CPU one than quantization moves it.
13. The reward and eval backbones at full width in bf16 (PyTorch's default
   initialisation from a seed): DINOv2-base on 20 images of 1024^2,
   CLIP-L/14 on 64, Depth-Anything-V2-S on 80 of 512^2 (518^2 inside),
   SegFormer-b4 on 8, InceptionV3 (1000 logits, and 2048 pool3 features)
   on 32: shapes, finite, depth >= 0 and not constant, classes in [0, 150),
   kernel #1 exactly 12 / 24 / 12 / 41 / 0 launches per call, all "mma";
   ms per call, images/s, peak memory, bytes.
14. The tiny f32 backbones and the resize helper on the card and on the
   CPU, TF32 off, within 5e-4 of each output's largest value.
15. The eval stack: 16 SD-1.5 previews and their DDIM teachers written as
   PNGs, ``evaluate_consistency`` with the dino reward over them, FID of
   two streams of 64 images through InceptionV3's pool3 features, and
   ``dino_vis.visualize``: counts, no error record, finite statistics.
16. PPO training of the SD-1.5 FactorNet at full width with the settings of
   ``ExperimentConfig.sd15_ppo()`` (batch 80, CFG 3, steps in [2, 16),
   decode chunks of 8), rewarded by its ``depth`` reward (Depth-Anything-V2-S
   on the 80 decoded images and the 80 teacher images) against teacher
   latents that the port's own plain DDIM made (8 samples, 20 steps): two
   steps through ``PPOTrainer.fit`` with a checkpoint, a fresh trainer
   resumed from it bit-equal, kernel #1's launches against the count the
   step counts imply (32 n + 20 + 2 x 12, all "mma"), rewards finite and
   differing across the batch, the reward's ms and spread, s/step, peak
   memory and one profiled step; then one step over the hybrid int8
   pipeline (``image_psnr``, float teacher latents).
17. PPO training of the FLUX-Kontext FactorNet at full width with the
   settings of ``ExperimentConfig.flux_ppo()`` for one rank's group (batch
   10, 4 PPO epochs, guidance 2.5, steps in [2, 6)), rewarded by its
   ``dino`` reward (DINOv2-base), against one teacher edit from the port's
   Euler solver at 8 steps: one ``train_step`` (policy and Euler-baseline
   rollouts, three decodes, two reward calls), its launches (57 x 2 n + 5 +
   2 x 12), then one profiled step.
18. The tiny f32 SD stack, TF32 off: the PPO update on one flattened batch
   on the card and on the CPU, two train steps on the card, and a
   checkpoint-and-resume run on the card bit-equal to a straight one.
19. The command line (``python -m consolver_torch <command>`` through
   ``__main__.main`` in this process) from checkpoints on disk: a full-width
   SD-1.5 hub directory in f32 (the UNet in 2 shards with an index), written
   from seeded bf16 weights, and an InceptionV3, each converted (bytes, write
   and load seconds, GB/s, the host's peak RSS while loading); ``generate``
   of 8 prompts bit-equal to the in-memory pipeline with 257 launches;
   ``generate-teacher`` of 80 prompts (DDIM 20), ``train-sd --preset
   sd15_ppo`` for 2 steps (launches 32 n + 20 a step) and a resumed third;
   ``evaluate consistency`` and ``fid`` (16 + 16 images, the converted
   InceptionV3); ``quantize`` (int8 hybrid) reloaded bit-equal to
   ``quantize()`` with 257 launches; then FLUX-Kontext at full width, depth
   cut to 2 double + 4 single blocks and T5 to 2 layers, from a bf16 hub
   directory: ``convert``, ``generate-teacher`` of 10 edits (Euler 8),
   ``train-flux --preset flux_ppo`` for one step ((2 + 4) 2 n + 5 launches)
   and ``quantize --bits 4`` reloaded bit-equal to ``quantize(bits=4)``.
20. Serving at full width through one ``ServeServer`` on 127.0.0.1 with both
   engines (SD-1.5: batch shapes 1 and 8; FLUX-Kontext: 1024^2, 128 T5
   tokens): prewarm, 3 rounds of 8 concurrent ``/v1/generate`` (one batch
   of 8 each, 0 pad rows; served img/s, p50 / p95 latency), the 9 zoo
   solvers (kernel #1 launches 32 x model calls + 1, all "mma", distinct
   images), a deterministic request alone and at every slot 0-7 of full
   batches (bit-equal), ``/v1/generate`` and ``/v1/refine`` bit-equal to
   direct ``TextToImagePipeline.__call__``, a hot reload (the image changes
   and equals the new net's direct call; other dims return 409), a
   ``PreviewSession``, and ``/v1/edit`` (fmppo, Euler) and
   ``/v1/edit/refine`` from a 1024x768 PNG (57 x steps + 2 launches, one
   reference resize on the card each, counts reset before each post); peak
   memory with both engines resident.  Then the int8 engines behind a
   second server (SD hybrid int8, FLUX int8 edits): 2 rounds of 8
   concurrent generates, the deterministic request bit-equal at every
   slot, a hot reload and one ``/v1/edit``.  Phase 2 also gates kernel #1
   at the shapes serving adds (UNet batch 2, 8320 joint tokens).
21. Data and tensor parallelism (``consolver_torch/dist/``): a world-1 NCCL
   group's all_reduce, all_gather and broadcast on the card, then two ranks
   (gloo, both on the one card; NCCL with a card each where there are two):
   (a) one SD-1.5 PPO step over 2 data ranks (``sd15_ppo()``, 80 rows a
   rank, 2 groups, depth, n = 6): launches per rank, bit-equal parameters
   across ranks, one checkpoint written by rank 0 and resumed bit-equal by
   both, and the one-process step on the same 160 rows beside it; (b) the
   FLUX-Kontext DiT split over 2 model ranks (built on ``meta`` and split
   block by block): one forward against phase 7's unsharded forward with
   its 77 all_reduces and 77 all_gathers counted and timed, then one
   deterministic edit through ``EditInferenceEngine(mesh=)`` against phase
   7's; (c) the SD-1.5 engine over 2 data ranks: 2 batches of 8
   deterministic requests against the unsharded engines at batch 8 and 4,
   bit-equal to both.  Phase 2 gates kernel #1 at the shapes they add (12 local heads at TP 2;
   one rank's UNet batch 8).
22. Images read by content: every JPEG fixture of ``tests/data/jpeg``
   (baseline 4:4:4 / 4:2:2 / 4:2:0, gray, progressive, restart intervals,
   odd sizes, Adobe RGB, 512^2) decoded by ``utils/jpeg.py`` bit-equal to
   the PNG of PIL's decode committed beside it; host ms per 512^2 decode
   (run first, on the host alone).
23. The policy variants (``ContinuousFactorNet``, ``MuNet``) on the card
   against the CPU (after phase 18).
24. The learning checks (``cli/learning_check.py`` SD, SD with the int8
   rollout, ``cli/learning_check_edit.py`` FLUX), each in a process of its
   own on the card, running beside phase 19: "LEARNING" (the last window's
   mean reward beats the first's by more than 0.05), kernel #1 on "fma".
25. ``serve --family both`` through the CLI's ``main`` in this process on
   phase 19's SD-1.5 and depth-cut FLUX-Kontext directories (batch shapes 1
   and 8, adaptive flush, ``--prewarm 8``): start-up seconds, 2 rounds of 8
   concurrent generates (img/s, p50 / p95; 257 launches a batch), a refine,
   an edit (6 x 5 + 2 launches), then SIGTERM with a batch of 8 in flight,
   all answered before ``main`` returns; a deterministic request bit-equal
   to an in-memory engine over the same weights.
26. ``generate-edit`` over a kontext-bench-shaped folder (two JPEG
   fixtures, one keyed) on the depth-cut FLUX directory at 1024^2, at
   batch sizes 1 and 2: folder names, ``score_results`` (PSNR scorer) with
   no error, the noise per example the same at both sizes, launches.
27. LoRA: a rank-64 LoRA on all 128 attention projections of the full-width
   SD-1.5 UNet (peft and kohya keys of the same pairs) merged with
   ``merge_lora``: kohya bit-equal to peft, within one bf16 ulp of an f32
   ``addmm`` of ``W + (alpha / r) B A``; one generation of 8, 257 launches.
28. The edit reference's crop-resize kernel (``kernels/resize.py``, built
   in phase 1 beside the others) at the 17 Kontext-preferred source sizes
   to 1024^2 (run after 22): bit-equal once per size to the host path
   (``center_crop_resize * 2 - 1``); the kernel's device ms (CUDA graphs of
   10 launches), the engine's upload and launch (host clock, synchronised)
   and the host path's ms (host clock), beside the kernel's bound (its
   bytes, source and tables in and float32 out, over 3.35 TB/s).  Its
   launches on the main path are checked in 20: each ``/v1/edit`` (Euler,
   refine, deterministic and int8 included) resizes its reference once, on
   the card (``resize.launches_by_route == {"card": 1, "host": 0}``, in
   ``by_path["serve_edit"]`` and the ``kernels`` line).
5 also times the deterministic program (mode actions, slot-invariant UNet
convolutions) beside the sampled one.

The line before the last is a JSON object listing each kernel (launches on
its main path, worst error, times); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import copy
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

BF16_TFLOPS = 989.0  # H100 SXM dense peaks (NVIDIA data sheet)
INT8_TOPS = 1979.0
F32_TFLOPS = 67.0  # float32 outside the tensor cores
HBM_TBPS = 3.35

# Kernel vs its plain version in f32 on the same inputs, held at every
# element: |out - ref| <= rtol * |ref| + atol.  The kernel computes in f32
# and rounds once to the output type, so a bf16 output may be off by half a
# bf16 ulp (2^-8 of |ref|); the limit allows one ulp.  atol covers the f32
# summation order (f32 runs differ by a few 1e-6).
F32_RTOL, F32_ATOL = 0.0, 1e-4
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-5
SLICE_TOL = 5e-4  # f32 tiny stack, card vs CPU through 3 CFG-3 steps
TRAIN_TOL = 1e-5  # f32 PPO updates of the policy, card vs CPU, on one batch
# The tiny FLUX stack, f32 card vs CPU through 3 steps: its guidance
# embedding takes sin/cos of guidance * 1000 = 2500 rad, where one f32 ulp
# of the argument is 2.4e-4, and the two devices' sin/cos and sums differ.
FLUX_SLICE_TOL = 1e-3
# Kernels #2-#4 vs their plain versions: the shares of elements past one
# bf16 ulp, and for int8 of elements differing at all (``phase_variants``).
SHARE_PAST_ULP = 1e-3
INT8_SHARE_DIFFERING = 1e-5

BATCH = 8
STEPS = 8
CFG = 3.0
PROMPTS = [
    "a red fox in the snow", "an astronaut riding a horse", "a bowl of ramen",
    "a lighthouse at dusk", "a watercolor of a city street", "a cat wearing a hat",
    "mountains above the clouds", "a robot reading a book",
]

# (name, q shape, Sk, launches per generation).  CFG doubles the UNet batch;
# per UNet forward each resolution level runs 5 Transformer2D blocks (2 down,
# 3 up), the mid block 1, each with one self- and one cross-attention.
MAIN_PATH_CASES = [
    ("unet_l0_self", (2 * BATCH, 4096, 8, 40), 4096, 5 * STEPS),
    ("unet_l0_cross", (2 * BATCH, 4096, 8, 40), 77, 5 * STEPS),
    ("unet_l1_self", (2 * BATCH, 1024, 8, 80), 1024, 5 * STEPS),
    ("unet_l1_cross", (2 * BATCH, 1024, 8, 80), 77, 5 * STEPS),
    ("unet_l2_self", (2 * BATCH, 256, 8, 160), 256, 5 * STEPS),
    ("unet_l2_cross", (2 * BATCH, 256, 8, 160), 77, 5 * STEPS),
    ("unet_mid_self", (2 * BATCH, 64, 8, 160), 64, STEPS),
    ("unet_mid_cross", (2 * BATCH, 64, 8, 160), 77, STEPS),
    ("vae_mid", (BATCH, 4096, 1, 512), 4096, 1),
]
EXTRA_CASES = [
    ("sq_ne_sk", (2, 256, 2, 128), 384, 0),
    ("ragged_200", (2, 200, 2, 128), 200, 0),
    ("large_scores", (1, 128, 1, 128), 128, 0),
]
LAUNCHES_PER_GENERATION = sum(c[3] for c in MAIN_PATH_CASES)

# The FLUX-Kontext edit: 1024^2 reference and output, 128x128x16 latents ->
# 4096 target + 4096 reference + 512 T5 tokens = 8704 joint tokens; per
# DiT forward 19 double + 38 single blocks each run one joint attention.
FLUX_STEPS = 5
FLUX_GUIDANCE = 2.5
FLUX_CASES = [
    ("flux_joint", (1, 8704, 24, 128), 8704, FLUX_STEPS * 57),
    ("flux_vae_mid", (1, 16384, 1, 512), 16384, 2),  # encode + decode
]
LAUNCHES_PER_EDIT = sum(c[3] for c in FLUX_CASES)

# Stable Diffusion 3.5 Large as `serve --family sd35` serves it (SD3Pipeline):
# 1024^2, 128x128x16 latents -> 4096 image tokens (patch 2) + 77 CLIP + 256
# T5 tokens = 4429 joint tokens, 38 heads x 64; one 2-row CFG MMDiT call a
# step, one joint attention in each of its 38 blocks.  4429 = 69 * 64 + 13,
# so the last query and key tiles are partial.  The decode's VAE mid block
# at 1024^2 is FLUX's shape.
SD35_STEPS = 8
SD35_GUIDANCE = 3.5
SD35_T5_TOKENS = 256
SD35_JOINT = 4096 + 77 + SD35_T5_TOKENS
SD35_CASES = [
    ("sd35_joint", (2, SD35_JOINT, 38, 64), SD35_JOINT, SD35_STEPS * 38),
    ("sd35_vae_mid", (1, 16384, 1, 512), 16384, 1),  # the decode
]
LAUNCHES_PER_SD35_PREVIEW = sum(c[3] for c in SD35_CASES)


def launches_by_design(fa, cases):
    """Kernel #1's tensor-core launches per design that ``cases`` imply (the
    model's operands arrive aligned): SD-1.5 H at levels 0 (self) and 1, A
    at level 0's cross-attention and levels 2 and mid, B in the VAE; FLUX
    and SD3.5 H but the VAE's B."""
    want = {"A": 0, "B": 0, "H": 0}
    for _, (_, sq, _, d), sk, n in cases:
        want[fa.mma_design(d, True, sq, sk)] += n
    return want


def _check_designs(fa, cases, what):
    got = dict(fa.flash_attention.launches_by_design)
    want = launches_by_design(fa, cases)
    if got != want:
        raise AssertionError(f"{what}: kernel #1 launches by design {got}, want {want}")
    return got

# Shapes the serving path adds, gated with 0 counted launches: a lone SD-1.5
# request under CFG (UNet batch 2) and the edit engine's 128 T5 tokens
# (4096 + 4096 + 128 joint tokens).
SERVE_T5_TOKENS = 128
SERVE_CASES = [
    ("serve_unet_l0_self", (2, 4096, 8, 40), 4096, 0),
    ("serve_unet_l0_cross", (2, 4096, 8, 40), 77, 0),
    ("serve_unet_l1_self", (2, 1024, 8, 80), 1024, 0),
    ("serve_unet_l1_cross", (2, 1024, 8, 80), 77, 0),
    ("serve_unet_l2_self", (2, 256, 8, 160), 256, 0),
    ("serve_unet_l2_cross", (2, 256, 8, 160), 77, 0),
    ("serve_unet_mid_self", (2, 64, 8, 160), 64, 0),
    ("serve_unet_mid_cross", (2, 64, 8, 160), 77, 0),
    ("serve_flux_joint", (1, 8192 + SERVE_T5_TOKENS, 24, 128), 8192 + SERVE_T5_TOKENS, 0),
]

# Shapes the data- and tensor-parallel paths add (phase_dist), gated with 0
# counted launches: the FLUX joint attention at TP 2 (12 local heads) and
# SD-1.5's level-0 self-attention of one data rank's 4 requests under CFG.
DIST_CASES = [
    ("dist_flux_joint_tp2", (1, 8704, 12, 128), 8704, 0),
    ("dist_unet_l0_self_dp2", (8, 4096, 8, 40), 4096, 0),
]

# Kernel #1 per model call, from the cases above: per CFG-batched UNet
# forward (32), per VAE decode call of the SD path (1) and per DiT forward
# (57) or FLUX VAE encode / decode call (1).
UNET_LAUNCHES = sum(c[3] for c in MAIN_PATH_CASES if c[0].startswith("unet")) // STEPS
SD_VAE_LAUNCHES = sum(c[3] for c in MAIN_PATH_CASES if c[0].startswith("vae"))
DIT_LAUNCHES = sum(c[3] for c in FLUX_CASES if c[0] == "flux_joint") // FLUX_STEPS
FLUX_VAE_LAUNCHES = sum(c[3] for c in FLUX_CASES if c[0] == "flux_vae_mid") // 2

# The reward and eval backbones (ROADMAP A.12), every attention at head dim
# 64 and unmasked: (name, q shape, Sk, kernel #1 launches per backbone call).
# DINOv2-base over a FLUX PPO reward call's 10 + 10 images, CLIP-L/14 over 32
# pairs, Depth-Anything-V2-S over an SD PPO step's 80 images (518^2, 1370
# tokens), SegFormer-b4's four stages at batch 8 (keys reduced to 256).
BACKBONE_CASES = [
    ("dino_base", (20, 257, 12, 64), 257, 12),
    ("clip_l14", (64, 257, 16, 64), 257, 24),
    ("depth_anything_s", (80, 1370, 6, 64), 1370, 12),
    ("segformer_s1", (8, 16384, 1, 64), 256, 3),
    ("segformer_s2", (8, 4096, 2, 64), 256, 8),
    ("segformer_s3", (8, 1024, 5, 64), 256, 27),
    ("segformer_s4", (8, 256, 8, 64), 256, 3),
]
# (backbone, batch, source side, kernel #1 cases it runs): the images each
# production caller hands it (512^2 SD decodes, 1024^2 FLUX decodes).
BACKBONES = [
    ("dino", 20, 1024, ("dino_base",)),
    ("clip", 64, 512, ("clip_l14",)),
    ("depth", 80, 512, ("depth_anything_s",)),
    ("segment", 8, 512, ("segformer_s1", "segformer_s2", "segformer_s3", "segformer_s4")),
    ("inception", 32, 512, ()),
    ("inception_pool3", 32, 512, ()),
]
BACKBONE_LAUNCHES = {name: sum(c[3] for c in BACKBONE_CASES if c[0] in cases)
                     for name, _, _, cases in BACKBONES}

# SD-1.5 PPO: ExperimentConfig.sd15_ppo(), consolver_tpu/configs/config.py:79-107,
# rewarded by depth (Depth-Anything-V2-S).
PPO_SEED = 453645634
SD_PPO_BATCH = 80
SD_PPO_STEP_RANGE = (2, 16)
SD_PPO_LR, SD_PPO_WD, SD_PPO_ADV_SCALE, SD_PPO_EPOCHS = 1e-4, 1e-3, 10.0, 1
SD_PPO_DECODE_CHUNK = 8
SD_PPO_TRAIN_STEPS = 2
SD_TEACHER_SAMPLES, SD_TEACHER_STEPS = 8, 20

# FLUX-Kontext PPO: ExperimentConfig.flux_ppo(), config.py:110-142, for ONE
# rank's group of 10 (the preset runs 8 ranks: ROADMAP Queue A.15), rewarded
# by dino (DINOv2-base).  The teacher runs 8 Euler steps, not the
# reference's 28, to save card time.
FLUX_PPO_BATCH = 10
FLUX_PPO_STEP_RANGE = (2, 6)
FLUX_PPO_LR, FLUX_PPO_WD, FLUX_PPO_EPOCHS = 1e-3, 1e-3, 4
FLUX_TEACHER_STEPS = 8


def sd_ppo_launches(num_inference, batch=SD_PPO_BATCH, chunk=SD_PPO_DECODE_CHUNK, reward=0):
    """Kernel #1 launches of one SD PPO step: a CFG-batched UNet call per
    inference step, the decodes of the policy's and the teacher's latents in
    chunks, and the reward's backbone (``reward`` launches per call) on each
    of the two image batches (``depth(pred)``, ``depth(target)``)."""
    return UNET_LAUNCHES * num_inference + 2 * -(-batch // chunk) * SD_VAE_LAUNCHES + 2 * reward


def flux_ppo_launches(num_inference, batch=FLUX_PPO_BATCH, chunk=None, reward=0):
    """Kernel #1 launches of one FLUX PPO step: a DiT forward per inference
    step of the policy and of the Euler-baseline rollout; VAE encodes of the
    reference for both; decodes of the policy's and the teacher's latents
    (chunked) and of the baseline's; the reward's encoder (``reward``
    launches per call) once for the policy rows and once for the baseline
    (train_edit.py:87-88), each over predictions and targets together."""
    decodes = 2 * (1 if chunk is None else -(-batch // chunk)) + 1
    return DIT_LAUNCHES * 2 * num_inference + (2 + decodes) * FLUX_VAE_LAUNCHES + 2 * reward

# Kernels #2-#4: (name, shape, block_q, block_k, variants).  The serving and
# training shapes of the probe, a ragged case for the masked variants, and
# for int8 a partial tile inside a chunk (Sk = 77) and 1024-key chunks with
# a ragged last one (3000 = 2 x 1024 + 952).
VARIANT_CASES = [
    ("serve", (1, 8704, 24, 128), 512, 512, ("flash_bf16", "flash_int8", "flash_nomask")),
    ("train", (8, 2560, 24, 128), 512, 512, ("flash_bf16", "flash_int8", "flash_nomask")),
    ("ragged_200", (2, 200, 2, 128), 128, 128, ("flash_bf16", "flash_int8")),
    ("ragged_77", (2, 77, 2, 128), 128, 128, ("flash_int8",)),
    ("block_k_1024", (1, 3000, 8, 128), 1024, 1024, ("flash_int8",)),
]
VARIANT_SOURCES = {
    "flash_bf16": "scripts/probe_flash_variants.py:70",
    "flash_int8": "scripts/probe_flash_variants.py:148",
    "flash_nomask": "scripts/probe_flash_variants.py:307",
}


def _time_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls=10, reps=5):
    """Device ms of one ``fn()`` call: the median replay of a CUDA graph of
    ``calls`` calls, so that host time between launches does not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return sorted(times)[reps // 2]


def _design_ms(fa, q, k, v):
    """Device ms of designs H and A at a bf16 call whose padded width H can
    take (``H_WIDTHS``) with aligned rows: the measurement behind the rule
    in ``mma_design``."""
    import torch

    out = torch.empty_like(q)
    return {design: _graph_ms(lambda: fa.launch(q, k, v, out, design)) for design in ("H", "A")}


def _library_ms(q, k, v, iters):
    """Yardstick: one PyTorch call computing the same attention, in its own
    [B, H, S, D] layout (transposed outside the timed region)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)


def _bound(q_shape, sk, dtype):
    import torch

    b, sq, h, d = q_shape
    itemsize = torch.finfo(dtype).bits // 8
    ops = 4.0 * b * h * sq * sk * d
    peak = BF16_TFLOPS if dtype == torch.bfloat16 else F32_TFLOPS
    op_ms = ops / (peak * 1e12) * 1e3
    byte_ms = (2 * b * sq * h * d + 2 * b * sk * h * d) * itemsize / (HBM_TBPS * 1e12) * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def _case_path(name):
    """The path a kernel #1 case belongs to: "flux", "sd35", "backbone"
    (its ``per_generation`` is per backbone call) or "sd"."""
    if name in {c[0] for c in BACKBONE_CASES}:
        return "backbone"
    if name in {c[0] for c in SD35_CASES}:
        return "sd35"
    return "flux" if "flux" in name else "sd"


def phase_kernel(fa):
    """Kernel vs plain version at every case; returns per-case rows.  bf16
    must take the tensor-core route, f32 the FMA route."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype, rtol, atol, want_route in ((torch.bfloat16, BF16_RTOL, BF16_ATOL, "mma"),
                                          (torch.float32, F32_RTOL, F32_ATOL, "fma")):
        for name, q_shape, sk, per_gen in (MAIN_PATH_CASES + FLUX_CASES + SD35_CASES
                                           + SERVE_CASES + DIST_CASES + BACKBONE_CASES
                                           + EXTRA_CASES):
            b, sq, h, d = q_shape
            if name == "large_scores":
                q = torch.full(q_shape, 10.0, device="cuda", dtype=dtype)
                k = q.clone()
            else:
                q = torch.randn(q_shape, device="cuda", generator=gen).to(dtype)
                k = torch.randn((b, sk, h, d), device="cuda", generator=gen).to(dtype)
            v = torch.randn((b, sk, h, d), device="cuda", generator=gen).to(dtype)
            before = dict(fa.flash_attention.launches_by_route)
            before_design = dict(fa.flash_attention.launches_by_design)
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            route = [r for r, n in fa.flash_attention.launches_by_route.items() if n != before[r]]
            design = [x for x, n in fa.flash_attention.launches_by_design.items()
                      if n != before_design[x]]
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            # worst element's error as a share of its limit; the case passes at <= 1
            over_limit = (diff / (rtol * ref.abs() + atol)).max().item()
            ref_max = ref.abs().max().item()
            del ref, diff
            finite = bool(torch.isfinite(out).all())
            heavy = b * h * sq * sk * d > 1e10
            row = {
                "case": name, "dtype": str(dtype).replace("torch.", ""), "q": list(q_shape),
                "sk": sk, "path": _case_path(name),
                "route": route[0] if len(route) == 1 else route,
                "design": design[0] if len(design) == 1 else design or None,
                "padded_d": fa.padded_width(d, want_route),
                "per_generation": per_gen, "max_abs_err": err, "max_abs_ref": ref_max,
                "rtol": rtol, "atol": atol, "err_over_limit": over_limit,
                "ms": _time_ms(lambda: fa.flash_attention(q, k, v), 5 if heavy else 20, warmup=2),
                "plain_ms": _time_ms(lambda: fa.flash_attention_reference(q, k, v), 2 if heavy else 5),
                "library_ms": _library_ms(q, k, v, 5 if heavy else 20),
            }
            row["bound_ms"], row["bound_by"] = _bound(q_shape, sk, dtype)
            row["tflops"] = 4.0 * b * h * sq * sk * d / (row["ms"] * 1e9)
            if (want_route == "mma" and fa.padded_width(d, "mma") in fa.H_WIDTHS
                    and fa.rows_aligned(q, k, v)):
                device_ms = _design_ms(fa, q, k, v)
                row["device_ms_h"], row["device_ms_a"] = device_ms["H"], device_ms["A"]
                row["a_over_h"] = device_ms["A"] / device_ms["H"]
            row["ms_over_library"] = row["ms"] / row["library_ms"]
            row["ms_over_bound"] = row["ms"] / row["bound_ms"]
            print(json.dumps({"phase": "kernel", **row}), flush=True)
            if not finite or not over_limit <= 1.0:
                raise AssertionError(
                    f"flash_attention {name} {dtype}: max err {err}, {over_limit}x the limit "
                    f"{rtol} * |ref| + {atol}")
            if row["route"] != want_route:
                raise AssertionError(
                    f"flash_attention {name} {dtype} took {route}, want {want_route}")
            want_design = (fa.mma_design(d, fa.rows_aligned(q, k, v), sq, sk)
                           if want_route == "mma" else None)
            if row["design"] != want_design:
                raise AssertionError(
                    f"flash_attention {name} {dtype} ran design {design}, want {want_design}")
            rows.append(row)
            del q, k, v, out
    torch.cuda.empty_cache()
    # per padded width H can take: A's device time over H's at each main-path
    # shape (the extra cases left out), against the design the rule picks
    by_width = {}
    for row in rows:
        if "a_over_h" in row and row["case"] not in {c[0] for c in EXTRA_CASES}:
            by_width.setdefault(fa.padded_width(row["q"][3], "mma"), []).append(
                {"case": row["case"], "sk": row["sk"], "design": row["design"],
                 "a_over_h": row["a_over_h"]})
    print(json.dumps({"phase": "kernel1_h_widths", "by_width": by_width}), flush=True)
    return rows


def _release_card():
    """Free what earlier phases left: a FLUX pipeline's cached denoise
    functions close over the pipeline, a cycle only the garbage collector
    breaks (33.5 GB of FLUX weights)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _random_fill_(module, gen, std=0.02):
    import torch

    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, std, generator=gen)
    return module


def _sd15_models(gen):
    """The SD-1.5 UNet, CLIP text encoder and VAE in bf16, built on ``meta``
    and filled on the card with random-normal x0.02 weights."""
    import torch

    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig

    bf16 = torch.bfloat16
    unet = UNet2DCondition(UNetConfig.sd15(), device="meta", dtype=bf16).to_empty(device="cuda")
    text = ClipTextEncoder(ClipTextConfig.sd15(), device="meta", dtype=bf16).to_empty(device="cuda")
    vae = AutoencoderKL(VaeConfig.sd15(), device="meta", dtype=bf16).to_empty(device="cuda")
    for m in (unet, text, vae):
        _random_fill_(m, gen)
    return unet, text, vae


def _device_profile(fn):
    """Runs ``fn`` once under the profiler; returns its result and the run's
    wall ms, the device's busy ms, kernel #1's ms and share, the idle share
    and the top 10 kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = kernel_us = 0.0
    by_name = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.device_time_total if hasattr(evt, "device_time_total") else evt.cuda_time_total
        device_us += us
        if KERNEL1_SYMBOL in evt.name:
            kernel_us += us
        by_name[evt.name[:80]] = by_name.get(evt.name[:80], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return out, {
        "profiled_wall_ms": wall_ms, "device_busy_ms": device_us / 1e3,
        "flash_kernel_ms": kernel_us / 1e3,
        "flash_share_of_device_time": kernel_us / device_us if device_us else None,
        "device_idle_share": 1 - device_us / 1e3 / wall_ms if device_us else None,
        "top_device_ms": {name: us / 1e3 for name, us in top},
    }


def phase_main_path(fa):
    """Full-width SD-1.5 preview: 8 prompts, 512^2, 8 steps, CFG 3, bf16."""
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    unet, text, vae = _sd15_models(gen)
    policy = FactorNet(
        FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, family="sd"), device="cuda"
    )
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=policy,
                               tokenizer=HashTokenizer(), device="cuda")
    ids = tokenize_batch(HashTokenizer(), PROMPTS[:BATCH], 77)
    noise = torch.randn((BATCH, 64, 64, 4), device="cuda", generator=gen)

    def generate(seed, **kw):
        policy_gen = torch.Generator(device="cuda").manual_seed(seed)
        images, _ = pipe(policy_gen, ids, noise, num_inference_steps=STEPS,
                         guidance_scale=CFG, record=False, **kw)
        return images

    fa.reset_counts()
    images = generate(SEED + 2)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    by_route = dict(fa.flash_attention.launches_by_route)
    if tuple(images.shape) != (BATCH, 512, 512, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("non-finite images")
    lo, hi = images.min().item(), images.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"images outside [0, 1]: {lo} {hi}")
    if launches != LAUNCHES_PER_GENERATION or by_route["mma"] != LAUNCHES_PER_GENERATION:
        raise AssertionError(f"flash_attention launched {launches} times ({by_route}), want "
                             f"{LAUNCHES_PER_GENERATION} on mma")
    by_design = _check_designs(fa, MAIN_PATH_CASES, "SD-1.5 generation")

    generate(SEED + 3)  # warm-up after the first (autotuning) run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = 3
    run_s = []
    for i in range(runs):
        t0 = time.perf_counter()
        generate(SEED + 4 + i)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    elapsed = sum(run_s)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the deterministic program: mode actions and the slot-invariant UNet
    # convolutions (the repair's cost to a deterministic batch)
    generate(SEED + 3, deterministic_policy=True)
    det_run_s = []
    for i in range(runs):
        t0 = time.perf_counter()
        generate(SEED + 4 + i, deterministic_policy=True)
        torch.cuda.synchronize()
        det_run_s.append(time.perf_counter() - t0)
    _, profiled = _device_profile(lambda: generate(SEED + 10))
    result = {
        "phase": "main_path", "batch": BATCH, "steps": STEPS, "cfg": CFG, "resolution": 512,
        "launches": launches, "launches_by_route": by_route, "launches_by_design": by_design,
        "img_per_s": BATCH * runs / elapsed,
        "s_per_generation": elapsed / runs, "run_s": run_s, "peak_mem_gib": peak_gib,
        "deterministic_run_s": det_run_s,
        "deterministic_s_per_generation": sum(det_run_s) / runs,
        "deterministic_over_sampled": sum(det_run_s) / elapsed,
        "image_min": lo, "image_max": hi, **profiled,
    }
    print(json.dumps(result), flush=True)
    del pipe, unet, text, vae, images
    torch.cuda.empty_cache()
    return result


def _tiny_pipeline(device, models):
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.pipelines.t2i import TextToImagePipeline

    unet, text, vae, policy = (copy.deepcopy(m).to(device) for m in models)
    return TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=policy,
                               device=device)


def phase_tiny_slice(fa):
    """The tiny f32 stack on the card vs the CPU, TF32 off."""
    import numpy as np
    import torch

    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 20)
    models = [
        _random_fill_(UNet2DCondition(UNetConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(AutoencoderKL(VaeConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(FactorNet(FactorNetConfig(order_dim=3, scaler_dim=2, num_actions=11,
                                                use_conv=True), device="cpu"), gen, 0.3),
    ]
    cpu, gpu = _tiny_pipeline("cpu", models), _tiny_pipeline("cuda", models)
    ids = tokenize_batch(HashTokenizer(), PROMPTS[:2], 77, vocab_size=1000)
    noise = torch.randn((2, 8, 8, 4), generator=gen)
    out = {"phase": "tiny_slice"}
    for program, kwargs in (("per_count", {}), ("padded", {"padded_max_steps": 5})):
        before = fa.flash_attention.launches
        results = {}
        for name, pipe in (("cpu", cpu), ("cuda", gpu)):
            with torch.inference_mode():
                lat, traj = pipe(None, ids, noise, num_inference_steps=3, guidance_scale=CFG,
                                 deterministic_policy=True, decode=False, **kwargs)
                img = pipe.decode_latents(lat)
            results[name] = (lat.cpu(), img.cpu(), traj.actions.cpu())
        if fa.flash_attention.launches == before:
            raise AssertionError("the card's tiny run did not launch the kernel")
        lat_err = (results["cpu"][0] - results["cuda"][0]).abs().max().item()
        img_err = (results["cpu"][1] - results["cuda"][1]).abs().max().item()
        same_actions = torch.equal(results["cpu"][2], results["cuda"][2])
        out[program] = {"latent_max_abs_err": lat_err, "image_max_abs_err": img_err,
                        "actions_equal": same_actions}
        if not (lat_err <= SLICE_TOL and img_err <= SLICE_TOL and same_actions):
            raise AssertionError(f"tiny slice {program}: card vs cpu {out[program]}")
        if not np.isfinite(results["cuda"][0].numpy()).all():
            raise AssertionError("non-finite tiny latents")
    out["tol"] = SLICE_TOL
    print(json.dumps(out), flush=True)
    return out


def _heaviest_weight(q, k, scale):
    """The largest softmax weight of any row (``1 / l`` of its row), one
    head at a time, in f32."""
    import torch

    worst = 0.0
    for h in range(q.shape[2]):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(), k[:, :, h].float()) * scale
        worst = max(worst, torch.exp(s.amax(dim=-1) - torch.logsumexp(s, dim=-1)).max().item())
        del s
    return worst


def _variant_bound(name, q_shape):
    b, sq, h, d = q_shape
    ops = 4.0 * b * h * sq * sq * d
    peak = INT8_TOPS if name == "flash_int8" else BF16_TFLOPS
    op_ms = ops / (peak * 1e12) * 1e3
    byte_ms = 4 * b * sq * h * d * 2 / (HBM_TBPS * 1e12) * 1e3  # bf16 q, k, v in, out
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def phase_variants(fv):
    """Kernels #2-#4 vs their plain versions (the same chunks) per element.

    Limit ``|out - ref| <= 2^-7 |ref| + 1e-5 + flip``: one bf16 ulp of the
    output, plus one rounding flip, because the kernel's f32 score sums run
    in another order than cuBLAS's, so a ``p`` at a rounding boundary can
    round the other way.  With ``P`` the heaviest softmax weight of the case
    and ``V = max|v|``: bf16 and nomask ``flip = 2^-7 P V`` (one bf16 ulp of
    that ``p``); int8 ``flip = 2 P V / 127`` (a flipped ``round(p * 127)``
    moves its row by ``(v_j - out) / (127 l)``).

    That limit bounds one flip at any element; the shares bound how often
    anything differs, so that a small fault made everywhere fails too:
    * every variant: at most ``SHARE_PAST_ULP`` of the elements past the
      one-ulp limit (flips are rare: the CPU tests hold the same share);
    * int8: at most ``INT8_SHARE_DIFFERING`` of the elements differing at
      all.  The kernel repeats the plain version's f32 operations one by one
      on exact integer products with the same ``expf`` as torch's CUDA
      ``exp``, so the two agree bit for bit; a ``round(p * 127)`` taken
      against another max than the chunk's moves most rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    rows = []
    for case, q_shape, block_q, block_k, names in VARIANT_CASES:
        b, sq, h, d = q_shape
        q, k, v = (torch.randn(q_shape, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        heaviest = _heaviest_weight(q, k, 1.0 / d**0.5)
        vmax = v.float().abs().max().item()
        heavy = b * h * sq * sq * d > 1e10
        for name in names:
            kernel = getattr(fv, name)
            plain = getattr(fv, f"{name}_reference")
            int8 = name == "flash_int8"
            want_route = fv.kernel_route(q.dtype, "int8" if int8 else "bf16")
            before = dict(kernel.launches_by_route)
            out = kernel(q, k, v, block_q=block_q, block_k=block_k)
            torch.cuda.synchronize()
            route = next(r for r, n in kernel.launches_by_route.items() if n != before[r])
            ref = plain(q, k, v, block_q=block_q, block_k=block_k)
            flip = 2 * heaviest * vmax / 127 if int8 else BF16_RTOL * heaviest * vmax
            diff = (out.float() - ref.float()).abs()
            ulp_limit = BF16_RTOL * ref.float().abs() + BF16_ATOL
            row = {
                "phase": "variants", "kernel": name, "route": route, "case": case,
                "q": list(q_shape), "block_q": block_q, "block_k": block_k,
                "max_abs_err": diff.max().item(), "max_abs_ref": ref.float().abs().max().item(),
                "heaviest_weight": heaviest,
                "flip_atol": flip, "err_over_limit": (diff / (ulp_limit + flip)).max().item(),
                "share_past_one_ulp": (diff > ulp_limit).float().mean().item(),
                "share_differing": (diff > 0).float().mean().item(),
                "finite": bool(torch.isfinite(out).all()),
            }
            del diff, ulp_limit, ref
            iters = 5 if heavy else 20
            row["ms"] = _time_ms(lambda: kernel(q, k, v, block_q=block_q, block_k=block_k),
                                 iters, warmup=2)
            if int8:  # the wrapper's time, split: quantization + layout, the launch
                def operands():
                    return fv.int8_kernel_operands(*fv.quantize_int8(q, k, v))

                row["quant_ms"] = _time_ms(operands, iters, warmup=2)
                ops = operands()
                row["kernel_ms"] = _time_ms(lambda: fv.launch_int8(ops, q.dtype, block_k),
                                            iters, warmup=2)
                del ops
            row["plain_ms"] = _time_ms(lambda: plain(q, k, v, block_q=block_q, block_k=block_k),
                                       2 if heavy else 5)
            row["library_ms"] = None if int8 else _library_ms(q, k, v, iters)
            row["bound_ms"], row["bound_by"] = _variant_bound(name, q_shape)
            # the function's operations (4 B H Sq Sk d), not the two-pass kernel's 1.5x;
            # int8 from the launch alone, in TOP/s
            kernel_ms = row.get("kernel_ms", row["ms"])
            row["tops" if int8 else "tflops"] = 4.0 * b * h * sq * sq * d / (kernel_ms * 1e9)
            row["ms_over_library"] = row["library_ms"] and row["ms"] / row["library_ms"]
            row["ms_over_bound"] = kernel_ms / row["bound_ms"]
            print(json.dumps(row), flush=True)
            share_limit = INT8_SHARE_DIFFERING if int8 else 1.0
            if not (row["finite"] and row["err_over_limit"] <= 1.0
                    and row["share_past_one_ulp"] <= SHARE_PAST_ULP
                    and row["share_differing"] <= share_limit):
                raise AssertionError(f"{name} {case}: {row}")
            if route != want_route:
                raise AssertionError(f"{name} {case} took route {route}, want {want_route}")
            rows.append(row)
            del out
        del q, k, v
        torch.cuda.empty_cache()
    return rows


MMA_KERNEL = "bf16_mma_kernel"  # the tensor-core kernel's name inside its mangled symbols
MAX_MMA_SMEM = 113 * 1024  # at most this per block, so that 2 blocks fit on one SM


def _ptxas_report(text):
    """Per kernel symbol of a ``ptxas -v`` report: registers, spill bytes and
    static shared memory."""
    report, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            report[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0, "static_smem": 0}
            continue
        if name is None:
            continue
        for key, pattern in (("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem", r"(\d+) bytes smem")):
            found = re.search(pattern, line)
            if found:
                report[name][key] = int(found.group(1))
    return report


SASS_MMA_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA")  # float and integer tensor-core instructions


def _sass_mma_counts(library):
    """Per kernel symbol of the built library, its ``HMMA``, ``HGMMA``,
    ``IMMA`` and ``IGMMA`` instructions in ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = dict.fromkeys(SASS_MMA_OPS, 0)
        elif name is not None:
            for op in re.findall(r"\b(HGMMA|HMMA|IGMMA|IMMA)\b", line):
                counts[name][op] += 1
    return counts


def phase_mma_kernel(fv):
    """What the tensor-core kernel compiled to: registers and spills
    (ptxas), HMMA / HGMMA instructions (SASS), dynamic shared memory and
    resident blocks per SM (occupancy API).  Hard failures: no tensor-core
    instruction, more than MAX_MMA_SMEM or fewer than 2 blocks per SM."""
    from consolver_torch.kernels import _nvcc

    library = _nvcc.library_path(fv._SOURCE)
    ptxas = {n: r for n, r in _ptxas_report(library.with_suffix(".ptxas.txt").read_text()).items()
             if MMA_KERNEL in n}
    sass = {n: c for n, c in _sass_mma_counts(library).items() if MMA_KERNEL in n}
    occupancy = {}
    for variant in ("bf16", "nomask"):
        for vec in (True, False):
            smem, blocks = fv.mma_occupancy(variant, vec)
            occupancy[f"{variant}/{'cp.async' if vec else 'elementwise'}"] = {
                "dynamic_smem_bytes": smem, "blocks_per_sm": blocks}
    result = {"phase": "mma_kernel", "ptxas": ptxas, "sass": sass, "occupancy": occupancy}
    print(json.dumps(result), flush=True)
    if len(sass) != 4 or len(ptxas) != 4:
        raise AssertionError(f"expected 4 instantiations of {MMA_KERNEL}: {sorted(sass)}")
    for name, counts in sass.items():
        if counts["HMMA"] + counts["HGMMA"] == 0:
            raise AssertionError(f"{name} has no tensor-core instruction")
    for key, occ in occupancy.items():
        if occ["dynamic_smem_bytes"] > MAX_MMA_SMEM or occ["blocks_per_sm"] < 2:
            raise AssertionError(f"{MMA_KERNEL} {key}: {occ}")
    return result


IMMA_KERNEL = "int8_mma_kernel"
IMMA_OUTPUT_TYPES = ("float32", "float16", "bfloat16")


def phase_imma_kernel(fv):
    """What the int8 tensor-core kernel compiled to, per output type:
    registers and spills (ptxas), IMMA / IGMMA instructions (SASS), dynamic
    shared memory and resident blocks per SM (occupancy API).  Hard
    failures: an instantiation missing, no integer tensor-core instruction,
    fewer than 2 blocks per SM."""
    import torch

    from consolver_torch.kernels import _nvcc

    library = _nvcc.library_path(fv._SOURCE)
    ptxas = {n: r for n, r in _ptxas_report(library.with_suffix(".ptxas.txt").read_text()).items()
             if IMMA_KERNEL in n}
    sass = {n: c for n, c in _sass_mma_counts(library).items() if IMMA_KERNEL in n}
    occupancy = {}
    for dtype in IMMA_OUTPUT_TYPES:
        smem, blocks = fv.imma_occupancy(getattr(torch, dtype))
        occupancy[dtype] = {"dynamic_smem_bytes": smem, "blocks_per_sm": blocks}
    result = {"phase": "imma_kernel", "ptxas": ptxas, "sass": sass, "occupancy": occupancy}
    print(json.dumps(result), flush=True)
    if len(sass) != len(IMMA_OUTPUT_TYPES) or len(ptxas) != len(IMMA_OUTPUT_TYPES):
        raise AssertionError(f"expected {len(IMMA_OUTPUT_TYPES)} instantiations of {IMMA_KERNEL}: "
                             f"{sorted(sass)}")
    for name, counts in sass.items():
        if counts["IMMA"] + counts["IGMMA"] == 0:
            raise AssertionError(f"{name} has no integer tensor-core instruction")
    for key, occ in occupancy.items():
        if occ["blocks_per_sm"] < 2:
            raise AssertionError(f"{IMMA_KERNEL} {key}: {occ}")
    return result


KERNEL1_SYMBOL = "flash_fwd"  # in the name of every kernel #1 kernel, FMA and tensor-core
KERNEL1_MMA = re.compile(r"flash_fwd_mma_([ab])_kernelILi(\d+)ELb([01])E")  # design, width, vec
KERNEL1_WGMMA = re.compile(r"flash_fwd_(wgmma)_kernelILi(\d+)E")  # design H: width, TMA loads
MIN_BLOCKS_PER_SM = {"A": 2, "B": 1, "H": 1}


def phase_kernel1_build(fa):
    """What kernel #1's tensor-core kernels compiled to, per instantiation
    (design, padded head dim, staging): registers and spills (ptxas), HMMA /
    HGMMA instructions (SASS), threads, dynamic shared memory and resident
    blocks per SM (occupancy API).  Hard failures: an instantiation missing,
    no tensor-core instruction, fewer than 2 blocks per SM in design A or 1
    in designs B and H."""
    from consolver_torch.kernels import _nvcc

    library = _nvcc.library_path(fa._SOURCE)
    ptxas = _ptxas_report(library.with_suffix(".ptxas.txt").read_text())
    sass = _sass_mma_counts(library)
    instances = {}
    for symbol in sorted(set(ptxas) | set(sass)):
        found = KERNEL1_MMA.search(symbol) or KERNEL1_WGMMA.search(symbol)
        if not found:
            continue
        design = "H" if found.group(1) == "wgmma" else found.group(1).upper()
        width = int(found.group(2))
        vec = design == "H" or found.group(3) == "1"
        occ = fa.mma_occupancy(width, vec, design)
        if occ["design"] != design or occ["width"] != width:
            raise AssertionError(f"{symbol}: the launcher picks {occ} for d = {width}")
        staging = "tma" if design == "H" else "cp.async" if vec else "elementwise"
        key = f"{occ['design']}/d{width}/{staging}"
        instances[key] = {**ptxas.get(symbol, {}),
                          **sass.get(symbol, dict.fromkeys(SASS_MMA_OPS, 0)),
                          **occ}
    result = {"phase": "kernel1_build", "instances": instances}
    print(json.dumps(result), flush=True)
    # the reward / eval backbones' head dim (BACKBONE_CASES)
    print(json.dumps({"phase": "kernel1_build_d64", "instances": {
        key: row for key, row in instances.items() if "/d64/" in key}}), flush=True)
    want = 2 * len(fa.MMA_WIDTHS) + len(fa.WGMMA_WIDTHS)
    if len(instances) != want:
        raise AssertionError(f"expected {want} tensor-core instantiations of kernel #1: "
                             f"{sorted(instances)}")
    for key, row in instances.items():
        if row["HMMA"] + row["HGMMA"] == 0:
            raise AssertionError(f"kernel #1 {key} has no tensor-core instruction")
        if row["blocks_per_sm"] < MIN_BLOCKS_PER_SM[row["design"]]:
            raise AssertionError(f"kernel #1 {key}: {row['blocks_per_sm']} blocks per SM")
    return result


def phase_probe(fv):
    """The variants' main path: the probe entry point at full shapes."""
    from consolver_torch.probes import flash_variants as probe

    fv.reset_counts()
    t0 = time.perf_counter()
    result = probe.run("cuda", iters=5, seed=SEED + 40,
                       log=lambda line: print(f"probe: {line}", file=sys.stderr, flush=True))
    launches = {kernel.__name__: kernel.launches for kernel in fv.KERNELS}
    by_route = {kernel.__name__: dict(kernel.launches_by_route) for kernel in fv.KERNELS}
    result.update({"phase": "probe", "launches": launches, "launches_by_route": by_route,
                   "probe_s": time.perf_counter() - t0})
    print(json.dumps(result), flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the probe never launched {name}")
    return result


def _flux_models(device, dtype, tiny, gen, std):
    import torch

    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    if tiny:
        fcfg = FluxConfig.tiny()
        t5_cfg = T5Config(vocab_size=64, d_model=fcfg.joint_text_dim, d_kv=8, d_ff=64,
                          num_layers=1, num_heads=4)
        clip_cfg = ClipTextConfig(vocab_size=64, hidden_size=fcfg.pooled_text_dim, num_layers=1,
                                  num_heads=2, intermediate_size=32)
        vae_cfg = VaeConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                            latent_channels=4)
    else:  # FLUX-Kontext, T5-XXL, CLIP-L and the 16-channel FLUX VAE
        fcfg, t5_cfg, clip_cfg = FluxConfig.flux_kontext(), T5Config.xxl(), ClipTextConfig.sd15()
        vae_cfg = VaeConfig(latent_channels=16, scaling_factor=0.3611)
    build = "cpu" if tiny else "meta"
    models = [
        FluxTransformer(fcfg, device=build, dtype=dtype),
        T5Encoder(t5_cfg, device=build, dtype=dtype),
        ClipTextEncoder(clip_cfg, device=build, dtype=dtype),
        AutoencoderKL(vae_cfg, device=build, dtype=dtype),
    ]
    if not tiny:
        models = [m.to_empty(device=device) for m in models]
    for m in models:
        _random_fill_(m, gen, std)
    policy = FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11,
                                       hidden_dim=256, family="fm"), device=build if tiny else device)
    if tiny:
        _random_fill_(policy, gen, 0.3)
    return models + [policy]


def phase_flux(fa):
    """Full-width FLUX-Kontext edit: one 1024^2 edit, 5 steps, guidance 2.5."""
    import torch

    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.pipelines.edit import FluxKontextPipeline

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    t0 = time.perf_counter()
    transformer, t5, clip, vae, policy = _flux_models("cuda", torch.bfloat16, False, gen, 0.02)
    pipe = FluxKontextPipeline(transformer, t5, clip, vae, factor_net=policy, device="cuda")
    build_s = time.perf_counter() - t0
    prompt = ["make the sky a sunset orange"]
    t5_ids = tokenize_batch(HashTokenizer(vocab_size=32128, max_length=512), prompt, 512)
    clip_ids = tokenize_batch(HashTokenizer(), prompt, 77)
    ref_image = torch.rand((1, 1024, 1024, 3), device="cuda", generator=gen) * 2 - 1
    noise = torch.randn((1, 128, 128, 16), device="cuda", generator=gen)

    def edit(seed):
        policy_gen = torch.Generator(device="cuda").manual_seed(seed)
        images, _ = pipe(policy_gen, t5_ids, clip_ids, ref_image, noise,
                         num_inference_steps=FLUX_STEPS, guidance_scale=FLUX_GUIDANCE, record=False)
        return images

    fa.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = edit(SEED + 51)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    by_route = dict(fa.flash_attention.launches_by_route)
    if tuple(images.shape) != (1, 1024, 1024, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("non-finite images")
    lo, hi = images.min().item(), images.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"images outside [0, 1]: {lo} {hi}")
    if launches != LAUNCHES_PER_EDIT or by_route["mma"] != LAUNCHES_PER_EDIT:
        raise AssertionError(f"flash_attention launched {launches} times ({by_route}), want "
                             f"{LAUNCHES_PER_EDIT} on mma")
    by_design = _check_designs(fa, FLUX_CASES, "FLUX-Kontext edit")

    run_s = []
    for i in range(2):
        t0 = time.perf_counter()
        edit(SEED + 52 + i)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _, profiled = _device_profile(lambda: edit(SEED + 60))
    dist_ref = _flux_dist_reference(pipe)
    result = {
        "phase": "flux_edit", "resolution": 1024, "steps": FLUX_STEPS, "guidance": FLUX_GUIDANCE,
        "joint_tokens": 8704, "launches": launches, "launches_by_route": by_route,
        "launches_by_design": by_design,
        "models_build_s": build_s,
        "first_edit_s": first_s, "run_s": run_s, "s_per_edit": sum(run_s) / len(run_s),
        "peak_mem_gib": peak_gib, "image_min": lo, "image_max": hi, **profiled,
    }
    print(json.dumps(result), flush=True)
    result["dist_ref"] = dist_ref
    del pipe, transformer, t5, clip, vae, images
    torch.cuda.empty_cache()
    return result


def phase_sd35(fa):
    """Full-width Stable Diffusion 3.5 Large preview as the sd35 server runs
    it: one prompt, 1024^2, 8 fmppo steps with sampled actions, CFG 3.5 (2
    rows a step), T5 at 256 tokens, bf16; kernel #1's launches counted over
    that one preview, from zero."""
    import torch

    from consolver_torch.models.clip_text import ClipTextEncoder, ClipTextProjConfig
    from consolver_torch.models.mmdit import MMDiTConfig, SD3Transformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.sd3 import SD3Pipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    _release_card()
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    t0 = time.perf_counter()
    models = [m.to_empty(device="cuda") for m in (
        SD3Transformer(MMDiTConfig.sd35_large(), device="meta", dtype=bf16),
        ClipTextEncoder(ClipTextProjConfig.sd3_clip_l(), device="meta", dtype=bf16),
        ClipTextEncoder(ClipTextProjConfig.openclip_bigg(), device="meta", dtype=bf16),
        T5Encoder(T5Config.xxl(), device="meta", dtype=bf16),
        AutoencoderKL(VaeConfig(latent_channels=16, scaling_factor=1.5305), device="meta",
                      dtype=bf16))]
    for m in models:
        _random_fill_(m, gen)
    transformer, clip_l, clip_g, t5, vae = models
    transformer.init_pos_embed_()  # a buffer: computed, not drawn
    policy = FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11,
                                       hidden_dim=256, family="fm"), device="cuda")
    pipe = SD3Pipeline(transformer, clip_l, clip_g, t5, vae, factor_net=policy,
                       t5_max_length=SD35_T5_TOKENS, device="cuda")
    build_s = time.perf_counter() - t0
    ids = pipe.tokenize(["a red fox sitting in tall grass at sunrise"])
    noise = torch.randn((1, 128, 128, 16), device="cuda", generator=gen)

    def preview(seed):
        policy_gen = torch.Generator(device="cuda").manual_seed(seed)
        images, _ = pipe(policy_gen, ids, noise, num_inference_steps=SD35_STEPS,
                         guidance_scale=SD35_GUIDANCE, solver="fmppo", record=False)
        return images

    fa.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = preview(SEED + 71)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    by_route = dict(fa.flash_attention.launches_by_route)
    if tuple(images.shape) != (1, 1024, 1024, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("non-finite images")
    lo, hi = images.min().item(), images.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"images outside [0, 1]: {lo} {hi}")
    if launches != LAUNCHES_PER_SD35_PREVIEW or by_route["mma"] != LAUNCHES_PER_SD35_PREVIEW:
        raise AssertionError(f"flash_attention launched {launches} times ({by_route}), want "
                             f"{LAUNCHES_PER_SD35_PREVIEW} on mma")
    by_design = _check_designs(fa, SD35_CASES, "SD3.5 preview")
    run_s = []
    for i in range(2):
        t0 = time.perf_counter()
        preview(SEED + 72 + i)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    result = {
        "phase": "sd35_preview", "resolution": 1024, "steps": SD35_STEPS,
        "guidance": SD35_GUIDANCE, "joint_tokens": SD35_JOINT, "launches": launches,
        "launches_by_route": by_route, "launches_by_design": by_design,
        "models_build_s": build_s, "first_preview_s": first_s,
        "run_s": run_s, "s_per_preview": sum(run_s) / len(run_s),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "image_min": lo, "image_max": hi,
    }
    print(json.dumps(result), flush=True)
    del pipe, models, transformer, clip_l, clip_g, t5, vae, policy, images
    _release_card()
    return result


DIST_T5_TOKENS = 512  # 4096 + 4096 + 512 = 8704 joint tokens, as FLUX_CASES


def _dit_probe_inputs():
    """One DiT forward's inputs at the edit's shapes (8192 image and 512 text
    tokens), drawn on the card from a seed: the same in every process."""
    import torch

    from consolver_torch.models.flux import latent_image_ids

    g = torch.Generator(device="cuda").manual_seed(SEED + 70)
    img = torch.randn((1, 8192, 64), device="cuda", generator=g)
    txt = torch.randn((1, DIST_T5_TOKENS, 4096), device="cuda", generator=g)
    pooled = torch.randn((1, 768), device="cuda", generator=g)
    ids = torch.cat([latent_image_ids(128, 128, device="cuda"),
                     latent_image_ids(128, 128, offset=1.0, device="cuda")])
    return (img, txt, pooled, torch.full((1,), 500.0, device="cuda"),
            torch.full((1,), FLUX_GUIDANCE, device="cuda"), ids,
            torch.zeros((DIST_T5_TOKENS, 3), device="cuda"))


def _dist_edit_request():
    import numpy as np

    from consolver_torch.serve import EditRequest

    image = np.random.default_rng(SEED + 71).integers(0, 256, (1024, 1024, 3), np.uint8)
    return EditRequest(instruction="make the sky a sunset orange", image=image, seed=SEED + 72,
                       num_inference_steps=FLUX_STEPS, guidance_scale=FLUX_GUIDANCE,
                       deterministic=True)


def _flux_dist_reference(pipe):
    """phase_flux's unsharded references for phase_dist's TP-2 edit: one DiT
    forward's output, one deterministic edit through EditInferenceEngine,
    and the policy those used."""
    import torch

    from consolver_torch.serve import EditInferenceEngine

    with torch.inference_mode():
        dit_out = pipe.transformer(*_dit_probe_inputs()).float().cpu()
    with EditInferenceEngine(pipe, resolution=1024, batch_size=1,
                             t5_max_length=DIST_T5_TOKENS) as engine:
        edit = engine.generate(_dist_edit_request(), timeout=600)
    return {"dit_out": dit_out, "edit": edit,
            "policy": {k: v.cpu() for k, v in pipe.factor_net.state_dict().items()}}


def phase_tiny_flux(fa):
    """The tiny FLUX stack on the card vs the CPU, f32, TF32 off."""
    import torch

    from consolver_torch.pipelines.edit import FluxKontextPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 70)
    models = _flux_models("cpu", None, True, gen, 0.1)
    pipes = {dev: FluxKontextPipeline(*(copy.deepcopy(m).to(dev) for m in models[:4]),
                                      factor_net=copy.deepcopy(models[4]).to(dev), device=dev)
             for dev in ("cpu", "cuda")}
    t5_ids = torch.randint(1, 64, (1, 4), generator=gen)
    clip_ids = torch.randint(1, 64, (1, 4), generator=gen)
    ref_image = torch.rand((1, 16, 16, 3), generator=gen) * 2 - 1
    noise = torch.randn((1, 8, 8, 4), generator=gen)
    out = {"phase": "tiny_flux"}
    for program, kwargs in (("per_count", {}), ("padded", {"padded_max_steps": 5})):
        before = fa.flash_attention.launches
        results = {}
        for name, pipe in pipes.items():
            lat, traj = pipe(None, t5_ids, clip_ids, ref_image, noise, num_inference_steps=3,
                             guidance_scale=FLUX_GUIDANCE, deterministic_policy=True, decode=False,
                             **kwargs)
            img = pipe.decode_latents(lat)
            results[name] = (lat.cpu(), img.cpu(), traj.actions.cpu())
        if fa.flash_attention.launches == before:
            raise AssertionError("the card's tiny FLUX run did not launch the kernel")
        lat_err = (results["cpu"][0] - results["cuda"][0]).abs().max().item()
        img_err = (results["cpu"][1] - results["cuda"][1]).abs().max().item()
        same_actions = torch.equal(results["cpu"][2], results["cuda"][2])
        out[program] = {"latent_max_abs_err": lat_err, "image_max_abs_err": img_err,
                        "actions_equal": same_actions}
        if not (lat_err <= FLUX_SLICE_TOL and img_err <= FLUX_SLICE_TOL and same_actions):
            raise AssertionError(f"tiny FLUX {program}: card vs cpu {out[program]}")
        if not bool(torch.isfinite(results["cuda"][0]).all()):
            raise AssertionError("non-finite tiny FLUX latents")
    out["tol"] = FLUX_SLICE_TOL
    print(json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# The reward and eval backbones (ROADMAP A.12): DINOv2-base, CLIP-ViT-L/14,
# Depth-Anything-V2-S, SegFormer-b4 and InceptionV3, bf16 on the card, with
# PyTorch's default initialisation from a seed (random-normal x0.02 weights
# can leave Depth-Anything's last ReLU at 0 and the depth reward constant).
# Their BatchNorm statistics are buffers and keep mean 0, variance 1.
# ---------------------------------------------------------------------------


def _module_bytes(module):
    return sum(t.numel() * t.element_size() for t in (*module.parameters(), *module.buffers()))


def _wrap_backbone(name, model):
    """The reward / eval callable of a backbone module (``.model`` holds it)."""
    from consolver_torch.models.depth_anything import make_depth_fn
    from consolver_torch.models.inception import make_inception_encoder
    from consolver_torch.models.segformer import make_segment_fn
    from consolver_torch.models.vit import make_encoder

    if name in ("dino", "clip"):
        return make_encoder(model, name)
    if name == "depth":
        return make_depth_fn(model)
    if name == "segment":
        return make_segment_fn(model)
    return make_inception_encoder(model)


def _backbone_models(seed, device, dtype=None, tiny=False):
    """name -> backbone module, from PyTorch's default initialisation with
    the global RNG seeded by ``seed`` (the caller's stream is restored),
    Depth-Anything's last conv made non-negative and InceptionV3's convs
    He-initialised.
    Full width: dino / clip / inception through ``build_encoder_for``, the
    registry's entry point; ``tiny``: the test configurations (InceptionV3
    whole)."""
    import torch

    from consolver_torch.models.depth_anything import DepthAnything, DepthAnythingConfig
    from consolver_torch.models.inception import InceptionV3
    from consolver_torch.models.segformer import Segformer, SegformerConfig
    from consolver_torch.models.vit import ViT, ViTConfig
    from consolver_torch.rewards.registry import build_encoder_for

    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(seed)
        if tiny:
            clip_cfg = ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                                 num_heads=2, layerscale=False, quick_gelu=True,
                                 pre_norm_embed=True, patch_bias=False, projection_dim=16,
                                 ln_eps=1e-5)
            models = {"dino": ViT(ViTConfig.tiny(), device=device),
                      "clip": ViT(clip_cfg, device=device),
                      "inception": InceptionV3(1000, device=device)}
            depth_cfg, seg_cfg = DepthAnythingConfig.tiny(), SegformerConfig.tiny()
        else:
            models = {kind: build_encoder_for(kind, device=device, dtype=dtype).model
                      for kind in ("dino", "clip", "inception")}
            depth_cfg, seg_cfg = DepthAnythingConfig.small_v2(), SegformerConfig.b4_ade()
        models["depth"] = DepthAnything(depth_cfg, device=device, dtype=dtype)
        models["segment"] = Segformer(seg_cfg, device=device, dtype=dtype)
        models["inception_pool3"] = InceptionV3(0, device=device, dtype=dtype)
    # The head's last 1x1 conv reads 32 ReLU outputs: with PyTorch's default
    # init its sum can be negative at every pixel, and the final ReLU then
    # returns an all-zero map (a constant reward).  Non-negative weights and
    # bias give a positive map, as a trained model's is.  InceptionV3's
    # default-initialised convs shrink the signal about 6x in variance per
    # layer (to about 1e-7 at pool3, where every image looks alike): He's
    # init keeps it near 1 through conv, inference BatchNorm and ReLU.
    with torch.no_grad():
        for p in models["depth"].head.conv3.parameters():
            p.abs_()
        for name in ("inception", "inception_pool3"):
            for module in models[name].modules():
                if isinstance(module, torch.nn.Conv2d):
                    torch.nn.init.kaiming_normal_(module.weight, nonlinearity="relu")
    return models


def _check_backbone_output(name, out, batch, side):
    import torch

    want = {"dino": (batch, 768), "clip": (batch, 768), "depth": (batch, side, side),
            "segment": (batch, 128, 128), "inception": (batch, 1000),
            "inception_pool3": (batch, 2048)}[name]
    if tuple(out.shape) != want:
        raise AssertionError(f"{name}: output {tuple(out.shape)}, want {want}")
    if name == "segment":
        if not (int(out.min()) >= 0 and int(out.max()) < 150):
            raise AssertionError(f"segment: classes outside [0, 150): {out.min()}..{out.max()}")
        return
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite output")
    if name == "depth":
        flat = out.float().flatten(1)
        if float(flat.min()) < 0 or not bool((flat.amax(1) > flat.amin(1)).all()):
            raise AssertionError("depth: a map is negative or constant")


def phase_reward_backbones(fa):
    """Each backbone at full width in bf16 on the batch its production caller
    gives it (``BACKBONES``): one checked call (output shape, finite, depth
    >= 0 and not constant, classes in [0, 150), kernel #1 launches exactly
    ``BACKBONE_LAUNCHES`` all on "mma", counts set to 0 just before), then
    timed calls: ms per call, images/s, peak GiB, the backbone's bytes."""
    _release_card()
    import torch

    models = _backbone_models(SEED + 140, "cuda", torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 141)
    out = {"phase": "reward_backbones", "dtype": "bfloat16", "backbones": {}}
    for name, batch, side, _ in BACKBONES:
        fn = _wrap_backbone(name, models[name])
        images = torch.rand((batch, side, side, 3), generator=gen, device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        with torch.no_grad():
            result = fn(images)
        torch.cuda.synchronize()
        launches, by_route = _counts(fa)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check_backbone_output(name, result, batch, side)
        with torch.no_grad():
            ms = _time_ms(lambda: fn(images), 3)
        row = {"batch": batch, "source_side": side, "ms_per_call": ms,
               "images_per_s": batch / ms * 1e3, "peak_gib": peak,
               "model_bytes": _module_bytes(models[name]), "launches_per_call": launches,
               "launches_by_route": by_route, "launches_want": BACKBONE_LAUNCHES[name]}
        if name == "depth":
            row["depth_range"] = [float(result.min()), float(result.max())]
        out["backbones"][name] = row
        print(json.dumps({"phase": "reward_backbone", "name": name, **row}), flush=True)
        want = BACKBONE_LAUNCHES[name]
        if launches != want or by_route.get("mma", 0) != want:
            raise AssertionError(f"{name}: kernel #1 launched {launches} times ({by_route}) per "
                                 f"call, want {want} on mma")
        del images, result
    del models
    torch.cuda.empty_cache()
    return out


def phase_tiny_backbones(fa):
    """The tiny f32 backbones (each from its default initialisation on the
    CPU) and the resize helper, TF32 off, on the card and on the CPU: every
    output within SLICE_TOL of its largest value.  SegFormer is held by its
    logits (an argmax may flip on a near tie)."""
    import torch

    from consolver_torch.models.vit import IMAGENET_MEAN, IMAGENET_STD, preprocess
    from consolver_torch.utils import resize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_models = _backbone_models(SEED + 150, "cpu", tiny=True)
    card_models = {name: copy.deepcopy(m).to("cuda") for name, m in cpu_models.items()}
    gen = torch.Generator().manual_seed(SEED + 151)
    images = torch.rand((2, 40, 52, 3), generator=gen)
    pixels = torch.randn((2, 75, 75, 3), generator=gen)  # InceptionV3's smallest input

    def run(device, models):
        x = images.to(device)
        got = {name: _wrap_backbone(name, models[name])(x)
               for name in ("dino", "clip", "depth")}
        got["segment_logits"] = models["segment"](
            preprocess(x, 512, IMAGENET_MEAN, IMAGENET_STD, resize_to=None))
        got["inception"] = models["inception"](pixels.to(device))
        got["inception_pool3"] = models["inception_pool3"](pixels.to(device))
        got["resize_linear"] = resize.resize(x, (2, 61, 37, 3), "linear")
        got["resize_cubic"] = resize.resize(x, (2, 23, 90, 3), "cubic")
        got["resize_align_corners"] = resize.resize_align_corners(x, (81, 27))
        return {k: v.float().cpu() for k, v in got.items()}

    with torch.no_grad():
        want, got = run("cpu", cpu_models), run("cuda", card_models)
    # each output's worst difference over its largest value: InceptionV3's
    # default init shrinks its pooled features to about 1e-7
    out = {"phase": "tiny_backbones", "tol": SLICE_TOL,
           "max_abs_ref": {k: want[k].abs().max().item() for k in want}}
    out["max_rel_err"] = {k: (got[k] - want[k]).abs().max().item() / out["max_abs_ref"][k]
                          for k in want}
    print(json.dumps(out), flush=True)
    bad = {k: v for k, v in out["max_rel_err"].items() if not v <= SLICE_TOL}
    if bad:
        raise AssertionError(f"tiny backbones card vs cpu past {SLICE_TOL}: {bad}")
    return out


EVAL_PAIRS = 16  # SD-1.5 preview / teacher pairs written as PNGs
FID_IMAGES, FID_BATCH = 64, 32  # per stream


def phase_eval(fa):
    """The eval stack at full width: 16 SD-1.5 previews (the pipeline's
    learned solver, 8 steps) and their teachers (DDIM, 20 steps, the same
    noise) written as PNGs by ``eval/gen_sweep.generate_sweep``, scored by
    ``evaluate_consistency`` with the dino reward (DINOv2-base, bf16); FID
    between two streams of 64 images through InceptionV3's pool3 features;
    ``dino_vis.visualize`` on one image.  Gates: 16 pairs scored, no error
    record, finite statistics and FID, kernel #1's launches exactly 12 per
    DINO call (one batch of 16 pairs), 0 for FID, all "mma"."""
    _release_card()
    import tempfile

    import numpy as np
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.eval import dino_vis
    from consolver_torch.eval.consistency import evaluate_consistency
    from consolver_torch.eval.fid import compute_fid
    from consolver_torch.eval.gen_sweep import generate_sweep
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.rewards.registry import RewardModel, make_reward_fn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    unet, text, vae = _sd15_models(gen)
    pipe = TextToImagePipeline(
        unet, text, vae, DiffusionSchedule.sd15(),
        factor_net=FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11,
                                             family="sd"), device="cuda"),
        tokenizer=HashTokenizer(), device="cuda")
    models = _backbone_models(SEED + 161, "cuda", torch.bfloat16)
    dino = _wrap_backbone("dino", models["dino"])
    pool3 = _wrap_backbone("inception_pool3", models["inception_pool3"])
    del models

    def sampler(steps, solver):
        def generate(generator, prompts):
            noise = torch.randn((len(prompts), 64, 64, 4), generator=generator, device="cuda")
            ids = tokenize_batch(HashTokenizer(), list(prompts), 77)
            return pipe(generator, ids, noise, steps, CFG, solver=solver, record=False)[0]

        return generate

    out = {"phase": "eval"}
    prompts = (PROMPTS * -(-EVAL_PAIRS // len(PROMPTS)))[:EVAL_PAIRS]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for sub, steps, solver in (("preview", STEPS, "consistencysolver"),
                                   ("teacher", SD_TEACHER_STEPS, "ddim")):
            written = generate_sweep(sampler(steps, solver), prompts, f"{tmp}/{sub}",
                                     batch_size=BATCH, seed=SEED + 162, device="cuda")
            if len(written) != EVAL_PAIRS:
                raise AssertionError(f"{sub}: wrote {len(written)} of {EVAL_PAIRS} PNGs")
        out["generate_s"] = time.perf_counter() - t0
        reward = make_reward_fn("dino", RewardModel(encode=dino))
        fa.reset_counts()
        t0 = time.perf_counter()
        stats = evaluate_consistency(reward, f"{tmp}/preview", f"{tmp}/teacher",
                                     batch_size=EVAL_PAIRS)
        out["consistency_s"] = time.perf_counter() - t0
        out["consistency_launches"], out["consistency_by_route"] = _counts(fa)
    out["consistency"] = stats

    def stream(seed, smooth):
        g = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(FID_IMAGES // FID_BATCH):
            x = torch.rand((FID_BATCH, 512, 512, 3), generator=g, device="cuda")
            yield (x + x.roll(1, 1) + x.roll(1, 2)) / 3 if smooth else x

    fa.reset_counts()
    t0 = time.perf_counter()
    out["fid"] = compute_fid(pool3, stream(SEED + 163, False), stream(SEED + 164, True))
    out["fid_s"] = time.perf_counter() - t0
    out["fid_launches"], _ = _counts(fa)
    image = np.random.default_rng(SEED + 165).random((512, 512, 3)).astype(np.float32)
    fa.reset_counts()
    rgb = dino_vis.visualize(dino.model, image)
    out["dino_vis_shape"], (out["dino_vis_launches"], _) = list(rgb.shape), _counts(fa)
    print(json.dumps(out), flush=True)

    stat_keys = ("mean", "std", "min", "max", "median")
    if (stats["num_pairs"], stats["num_scored"], stats["num_errors"]) != (EVAL_PAIRS, EVAL_PAIRS, 0):
        raise AssertionError(f"evaluate_consistency: {stats}")
    if not all(np.isfinite(stats[k]) for k in stat_keys) or not np.isfinite(out["fid"]):
        raise AssertionError(f"non-finite eval statistics: {out}")
    want = BACKBONE_LAUNCHES["dino"]
    if (out["consistency_launches"], out["consistency_by_route"].get("mma")) != (want, want):
        raise AssertionError(f"consistency: kernel #1 {out['consistency_launches']} "
                             f"({out['consistency_by_route']}), want {want} on mma")
    if out["fid_launches"] != 0 or out["dino_vis_launches"] != want:
        raise AssertionError(f"FID / dino_vis launches: {out}")
    if rgb.shape != (16, 16, 3) or not (np.isfinite(rgb).all() and 0 <= rgb.min() <= rgb.max() <= 1):
        raise AssertionError(f"dino_vis: {rgb.shape}, {rgb.min()}..{rgb.max()}")
    del pipe, unet, text, vae, dino, pool3
    torch.cuda.empty_cache()
    return out


def _trainer_state(trainer):
    """The policy's parameters and its optimizer's whole state, as tensors."""
    import torch

    opt = trainer.optimizer
    state = [p.detach() for p in trainer.factor_net.parameters()]
    state += [v if torch.is_tensor(v) else torch.tensor(v)
              for p in opt.params for _, v in sorted(opt.adamw.state[p].items())]
    return state + list(opt.acc_grads) + [torch.tensor(opt.mini_step)]


def _bit_equal(a, b):
    import torch

    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def _states_equal(a, b):
    """Two state dicts with the same keys, dtypes and bits."""
    import torch

    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _check_metrics(metrics, names):
    import math

    for name in names:
        if not math.isfinite(metrics[name]):
            raise AssertionError(f"non-finite {name}: {metrics}")


def _timed_reward(reward, seen):
    """``reward`` that records each call's ms (synchronised), rows, dtype,
    finiteness, distinct values, spread and range in ``seen``."""
    import torch

    def reward_fn(pred, target):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = reward(pred, target)
        torch.cuda.synchronize()
        f = r.float()
        seen.append({"ms": (time.perf_counter() - t0) * 1e3, "rows": int(r.numel()),
                     "dtype": str(r.dtype).replace("torch.", ""),
                     "finite": bool(torch.isfinite(f).all()),
                     "distinct": int(torch.unique(r).numel()),
                     "std": float(f.std(correction=0)), "min": float(f.min()),
                     "max": float(f.max())})
        return r

    return reward_fn


def phase_sd_ppo(fa):
    """SD-1.5 PPO at full width: 2 steps of batch 80 through
    ``PPOTrainer.fit`` with the ``sd15_ppo()`` settings, its ``depth``
    reward (Depth-Anything-V2-S, bf16, default init from a seed) against the
    port's own 20-step DDIM teacher latents, a checkpoint at step 2 and a
    fresh trainer resumed from it.  The rewards must be finite and differ
    across the batch."""
    _release_card()
    import tempfile

    import numpy as np
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.group import TeacherDataset
    from consolver_torch.data.teacher_gen import generate_teacher_set
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch, uncond_input_ids
    from consolver_torch.pipelines.t2i import TextToImagePipeline, make_denoise_fn
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.models.depth_anything import make_depth_fn
    from consolver_torch.rewards.registry import RewardModel, make_reward_fn
    from consolver_torch.rl.ppo import PPOConfig
    from consolver_torch.rl.train import PPOTrainer, TrainConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    unet, text, vae = _sd15_models(gen)
    depth = make_reward_fn("depth", RewardModel(depth=make_depth_fn(
        _backbone_models(SEED + 81, "cuda", torch.bfloat16)["depth"])))
    policy_cfg = FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, hidden_dim=256,
                                 family="sd")

    def pipeline():
        return TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(),
                                   factor_net=FactorNet(policy_cfg, device="cuda"),
                                   tokenizer=HashTokenizer(), device="cuda")

    pipe = pipeline()
    teacher_denoise = make_denoise_fn(unet, pipe.schedule, None, SD_TEACHER_STEPS, CFG,
                                      pipe.timestep_spacing, pipe.steps_offset,
                                      record_trajectory=False)

    def teacher(generator, noise, ids):
        context, uncond_context = pipe._encode(ids, pipe.uncond_ids_for(ids))
        return teacher_denoise(generator, noise, context, uncond_context)[0]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        written = generate_teacher_set(
            teacher, tokenize_batch(HashTokenizer(), PROMPTS[:SD_TEACHER_SAMPLES], 77),
            f"{tmp}/teacher", (64, 64, 4), batch_size=SD_TEACHER_SAMPLES, seed=PPO_SEED,
            save_sanity_images=0, uncond_ids=uncond_input_ids(HashTokenizer(), 1, 77),
            device="cuda")
        torch.cuda.synchronize()
        teacher_s = time.perf_counter() - t0
        if written != SD_TEACHER_SAMPLES:
            raise AssertionError(f"the teacher wrote {written} of {SD_TEACHER_SAMPLES} samples")
        samples = next(TeacherDataset(f"{tmp}/teacher").batches(SD_TEACHER_SAMPLES))
        reps = SD_PPO_BATCH // SD_TEACHER_SAMPLES
        batch = {k: np.concatenate([v] * reps) for k, v in samples.items()}

        config = TrainConfig(
            max_train_steps=SD_PPO_TRAIN_STEPS, guidance_scale=CFG,
            min_inference_steps=SD_PPO_STEP_RANGE[0], max_inference_steps=SD_PPO_STEP_RANGE[1],
            seed=PPO_SEED, output_dir=f"{tmp}/run", checkpointing_steps=SD_PPO_TRAIN_STEPS,
            log_every=1, decode_chunk=SD_PPO_DECODE_CHUNK,
            ppo=PPOConfig(ppo_epochs=SD_PPO_EPOCHS, learning_rate=SD_PPO_LR,
                          weight_decay=SD_PPO_WD, advantage_scale=SD_PPO_ADV_SCALE))
        rewards_seen = []
        reward_fn = _timed_reward(depth, rewards_seen)

        trainer = PPOTrainer(pipe, reward_fn, config)
        before = [p.detach().clone() for p in pipe.factor_net.parameters()]
        steps = []

        def log(step, metrics):
            torch.cuda.synchronize()
            steps.append({"step": step, "s": time.perf_counter() - t0, **metrics})

        def batches():
            while True:
                yield batch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        t0 = time.perf_counter()
        trainer.fit(batches(), log_fn=log)
        torch.cuda.synchronize()
        global_step = trainer.global_step
        launches = fa.flash_attention.launches
        by_route = dict(fa.flash_attention.launches_by_route)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for i in range(len(steps) - 1, 0, -1):
            steps[i]["s"] -= steps[i - 1]["s"]

        resumed = PPOTrainer(pipeline(), depth, config)
        if not resumed.resume_from_checkpoint("latest") or resumed.global_step != global_step:
            raise AssertionError("no checkpoint to resume from")
        resume_bit_equal = _bit_equal(_trainer_state(resumed), _trainer_state(trainer))
        profile_step = trainer.global_step
        profiled_metrics, profiled = _device_profile(lambda: trainer.train_step(batch))
        del resumed
        int8 = phase_int8_ppo(fa, pipeline, batch, config)

    num_inference = [s["num_inference"] for s in steps]
    reward_launches = BACKBONE_LAUNCHES["depth"]
    want = sum(sd_ppo_launches(n, reward=reward_launches) for n in num_inference)
    result = {
        "phase": "sd_ppo", "batch": SD_PPO_BATCH, "cfg": CFG, "resolution": 512,
        "decode_chunk": SD_PPO_DECODE_CHUNK, "reward": "depth",
        "teacher": {"samples": written, "steps": SD_TEACHER_STEPS, "s": teacher_s},
        "steps": steps, "num_inference": num_inference,
        "s_per_step": [s["s"] for s in steps], "peak_mem_gib": peak_gib,
        "rewards": rewards_seen,
        "launches": launches, "launches_by_route": by_route, "launches_want": want,
        "global_step": global_step, "resume_bit_equal": resume_bit_equal,
        "profiled_step": {"step": profile_step, "num_inference": profiled_metrics["num_inference"],
                          "launches_want": sd_ppo_launches(profiled_metrics["num_inference"],
                                                           reward=reward_launches),
                          **profiled},
    }
    print(json.dumps(result), flush=True)
    result["int8_ppo"] = int8
    if len(steps) != SD_PPO_TRAIN_STEPS or global_step != SD_PPO_TRAIN_STEPS:
        raise AssertionError(f"fit ran {len(steps)} steps")
    for metrics in steps + [profiled_metrics]:
        _check_metrics(metrics, ("loss", "reward", "grad_norm"))
    if _bit_equal(before, [p.detach() for p in pipe.factor_net.parameters()]):
        raise AssertionError("the policy did not move")
    if launches != want or by_route.get("mma") != want:
        raise AssertionError(f"flash_attention launched {launches} times ({by_route}), want "
                             f"{want} on mma for num_inference {num_inference}")
    if not resume_bit_equal:
        raise AssertionError("the resumed trainer's policy or optimizer differs from the writer's")
    if not all(r["finite"] and r["distinct"] > 1 for r in rewards_seen):
        raise AssertionError(f"depth rewards non-finite or equal across the batch: {rewards_seen}")
    del trainer, pipe, unet, text, vae, depth
    torch.cuda.empty_cache()
    return result


def phase_int8_ppo(fa, pipeline, batch, config):
    """One SD-1.5 PPO step of batch 80 through ``PPOTrainer`` over the hybrid
    int8 pipeline (the JAX package's ``quantize_rollout`` environment): the
    teacher latents stay float, the rollout and its decodes run int8, only
    the FactorNet trains.  Its step count is the float run's first one
    (the same seed and step)."""
    import torch

    from consolver_torch.kernels import quant as tq
    from consolver_torch.rewards.registry import make_reward_fn
    from consolver_torch.rl.train import PPOTrainer

    qpipe = pipeline().quantize()
    trainer = PPOTrainer(qpipe, make_reward_fn("image_psnr"), config)
    before = [p.detach().clone() for p in qpipe.factor_net.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    tq.int_mm.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches, by_route = _counts(fa)
    want = sd_ppo_launches(metrics["num_inference"])
    moved = not _bit_equal(before, [p.detach() for p in qpipe.factor_net.parameters()])
    result = {
        "phase": "int8_ppo", "batch": SD_PPO_BATCH, "skip_levels": list(qpipe.unet.cfg.quant_skip_levels),
        "metrics": metrics, "num_inference": metrics["num_inference"], "s_per_step": step_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
        "launches_by_route": by_route, "launches_want": want, "int_mm_launches": tq.int_mm.launches,
        "policy_moved": moved,
    }
    print(json.dumps(result), flush=True)
    _check_metrics(metrics, ("loss", "reward", "grad_norm"))
    if not moved:
        raise AssertionError("the int8 rollout's policy did not move")
    if launches != want or by_route.get("mma") != want:
        raise AssertionError(f"int8 PPO: flash_attention launched {launches} times ({by_route}), "
                             f"want {want} on mma for num_inference {metrics['num_inference']}")
    if tq.int_mm.launches == 0:
        raise AssertionError("int8 PPO: the int8 GEMM never ran")
    del trainer, qpipe
    torch.cuda.empty_cache()
    return result


def phase_flux_ppo(fa):
    """FLUX-Kontext PPO at full width: one rank's group of the ``flux_ppo()``
    preset (batch 10; the preset's 8 data-parallel ranks wait for ROADMAP
    Queue A.15), its ``dino`` reward (DINOv2-base, bf16, default init from a
    seed) against one teacher edit of the port's Euler solver at 8 steps
    (the reference's teacher runs 28), one ``train_step`` and one profiled
    step.  The group's rows share their sample, and the preset's FM policy
    (temperature 0.01) picks the same actions for all of them at random
    init, so the policy rows' rewards may tie; they must be finite, and the
    Euler baseline's must differ from them."""
    _release_card()
    import tempfile

    import numpy as np
    import torch

    from consolver_torch.data.group import TeacherDataset
    from consolver_torch.data.teacher_gen import generate_edit_teacher_set
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.pipelines.edit import FluxKontextPipeline
    from consolver_torch.rewards.registry import RewardModel, build_encoder_for, make_reward_fn
    from consolver_torch.rl.ppo import PPOConfig
    from consolver_torch.rl.train import TrainConfig
    from consolver_torch.rl.train_edit import EditPPOTrainer

    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(SEED + 89)
        dino = make_reward_fn("dino", RewardModel(encode=build_encoder_for(
            "dino", device="cuda", dtype=torch.bfloat16)))
    rewards_seen = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    t0 = time.perf_counter()
    transformer, t5, clip, vae, policy = _flux_models("cuda", torch.bfloat16, False, gen, 0.02)
    pipe = FluxKontextPipeline(transformer, t5, clip, vae, factor_net=policy, device="cuda")
    build_s = time.perf_counter() - t0

    def tokenize(texts):
        return (tokenize_batch(HashTokenizer(vocab_size=32128, max_length=512), texts, 512),
                tokenize_batch(HashTokenizer(), texts, 77))

    def teacher(generator, noise, t5_ids, clip_ids, ref_image):
        return pipe.rollout(generator, t5_ids, clip_ids, ref_image, noise,
                            num_inference_steps=FLUX_TEACHER_STEPS, guidance_scale=FLUX_GUIDANCE,
                            solver="euler", decode=False, record=False)[0]

    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "prepared").mkdir()
        ref = np.random.default_rng(SEED + 91).uniform(-1, 1, (1024, 1024, 3)).astype(np.float32)
        np.savez(f"{tmp}/prepared/000000.npz", ref_image=ref,
                 instruction=np.asarray("make the sky a sunset orange"))
        t0 = time.perf_counter()
        written = generate_edit_teacher_set(teacher, tokenize, f"{tmp}/prepared", f"{tmp}/teacher",
                                            (128, 128, 16), seed=PPO_SEED, save_sanity_images=0,
                                            device="cuda")
        torch.cuda.synchronize()
        teacher_s = time.perf_counter() - t0
        if written != 1:
            raise AssertionError(f"the edit teacher wrote {written} samples")
        sample = next(TeacherDataset(f"{tmp}/teacher").batches(1))
        batch = {k: np.repeat(v, FLUX_PPO_BATCH, axis=0) for k, v in sample.items()}
        config = TrainConfig(
            max_train_steps=1, guidance_scale=FLUX_GUIDANCE,
            min_inference_steps=FLUX_PPO_STEP_RANGE[0], max_inference_steps=FLUX_PPO_STEP_RANGE[1],
            seed=PPO_SEED, output_dir=f"{tmp}/run",
            ppo=PPOConfig(ppo_epochs=FLUX_PPO_EPOCHS, learning_rate=FLUX_PPO_LR,
                          weight_decay=FLUX_PPO_WD, advantage_scale=1.0))
        trainer = EditPPOTrainer(pipe, _timed_reward(dino, rewards_seen), config)

    before = [p.detach().clone() for p in policy.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    by_route = dict(fa.flash_attention.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    reward_launches = BACKBONE_LAUNCHES["dino"]
    want = flux_ppo_launches(metrics["num_inference"], reward=reward_launches)
    moved = not _bit_equal(before, [p.detach() for p in policy.parameters()])
    profiled_metrics, profiled = _device_profile(lambda: trainer.train_step(batch))

    result = {
        "phase": "flux_ppo", "batch": FLUX_PPO_BATCH, "resolution": 1024,
        "guidance": FLUX_GUIDANCE, "ppo_epochs": FLUX_PPO_EPOCHS, "reward": "dino",
        "rewards": rewards_seen,
        "models_build_s": build_s,
        "teacher": {"samples": written, "steps": FLUX_TEACHER_STEPS, "s": teacher_s},
        "metrics": metrics, "num_inference": metrics["num_inference"], "s_per_step": step_s,
        "peak_mem_gib": peak_gib, "launches": launches, "launches_by_route": by_route,
        "launches_want": want, "policy_moved": moved,
        "profiled_step": {"num_inference": profiled_metrics["num_inference"],
                          "launches_want": flux_ppo_launches(profiled_metrics["num_inference"],
                                                             reward=reward_launches),
                          **profiled},
    }
    print(json.dumps(result), flush=True)
    for m in (metrics, profiled_metrics):
        _check_metrics(m, ("loss", "reward", "baseline_reward", "grad_norm"))
    if not moved:
        raise AssertionError("the policy did not move")
    if launches != want or by_route.get("mma") != want:
        raise AssertionError(f"flash_attention launched {launches} times ({by_route}), want "
                             f"{want} on mma for num_inference {metrics['num_inference']}")
    if not all(r["finite"] for r in rewards_seen) or any(
            abs(m["reward"] - m["baseline_reward"]) == 0 for m in (metrics, profiled_metrics)):
        raise AssertionError(f"dino rewards non-finite, or the baseline's equal: {rewards_seen}")
    del trainer, pipe, transformer, t5, clip, vae, policy, dino
    torch.cuda.empty_cache()
    return result


def phase_tiny_train(fa):
    """The tiny f32 SD stack, TF32 off: the PPO update on one flattened batch
    on the card and the CPU (loss, aux and parameters after 2 updates within
    TRAIN_TOL), two train steps on the card, and kill / resume on the card:
    2 steps straight against 1 step, a checkpoint, a fresh trainer resumed
    from it and 1 step, bit-equal in the policy and the optimizer."""
    import tempfile

    import numpy as np
    import torch

    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.rewards.registry import make_reward_fn
    from consolver_torch.rl import ppo
    from consolver_torch.rl.train import PPOTrainer, TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 100)
    models = [
        _random_fill_(UNet2DCondition(UNetConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(AutoencoderKL(VaeConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11),
                                device="cpu"), gen, 0.3),
    ]

    def batch(i):
        rng = np.random.default_rng(SEED + 110 + i)
        return {"noise": rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
                "latent": rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
                "prompt_ids": rng.integers(1, 1000, (4, 77))}

    def batches():
        i = 0
        while True:
            yield batch(i)
            i += 1

    def trainer(device, out, max_steps, ckpt_steps=100):
        config = TrainConfig(max_train_steps=max_steps, min_inference_steps=2,
                             max_inference_steps=5, seed=SEED + 120, output_dir=out,
                             checkpointing_steps=ckpt_steps, log_every=1,
                             ppo=ppo.PPOConfig(learning_rate=1e-3))
        return PPOTrainer(_tiny_pipeline(device, models), make_reward_fn("image_psnr"), config)

    out = {"phase": "tiny_train", "tol": TRAIN_TOL}
    with tempfile.TemporaryDirectory() as tmp:
        # one flattened batch from a CPU rollout, updated on both devices
        cpu = trainer("cpu", f"{tmp}/cpu", 1)
        pipe, data = cpu.pipe, batch(0)
        with torch.no_grad():
            ids = torch.as_tensor(data["prompt_ids"])
            context, uncond_context = pipe._encode(ids, pipe.uncond_ids_for(ids))
            latents, traj = pipe.denoise_fn(3, CFG)(torch.Generator().manual_seed(SEED + 130),
                                                   torch.as_tensor(data["noise"]), context,
                                                   uncond_context)
            _, advantages = cpu._decode_and_reward(latents, torch.as_tensor(data["latent"]))
        conds, *rest = ppo.flatten_trajectory(traj, advantages)
        updates = {}
        for device in ("cpu", "cuda"):
            net = copy.deepcopy(models[3]).to(device)
            config = cpu.config.ppo
            update = ppo.make_update_fn(net, ppo.make_optimizer(net, config), config)
            args = [{k: v.to(device) for k, v in conds.items()}] + [t.to(device) for t in rest]
            auxes = [{k: float(v) for k, v in update(*args).items()} for _ in range(2)]
            updates[device] = (auxes, [p.detach().cpu() for p in net.parameters()])
        aux_err = max(abs(a[k] - b[k]) / max(1.0, abs(a[k]))
                      for a, b in zip(updates["cpu"][0], updates["cuda"][0]) for k in a)
        param_err = max((a - b).abs().max().item()
                        for a, b in zip(updates["cpu"][1], updates["cuda"][1]))
        out["update"] = {"aux_max_rel_err": aux_err, "param_max_abs_err": param_err,
                         "aux_cuda": updates["cuda"][0]}

        before = fa.flash_attention.launches
        straight = trainer("cuda", f"{tmp}/straight", 2)
        straight.fit(batches(), log_fn=lambda step, m: out.setdefault("steps", []).append(m))
        out["launches"] = fa.flash_attention.launches - before
        killed = trainer("cuda", f"{tmp}/resume", 1, ckpt_steps=1)
        killed.fit(batches())
        resumed = trainer("cuda", f"{tmp}/resume", 2)
        if not resumed.resume_from_checkpoint("latest") or resumed.global_step != 1:
            raise AssertionError("no checkpoint to resume from")
        resumed.fit(batches())
        out["resume_bit_equal"] = _bit_equal(_trainer_state(resumed), _trainer_state(straight))
    print(json.dumps(out), flush=True)
    if not (aux_err <= TRAIN_TOL and param_err <= TRAIN_TOL):
        raise AssertionError(f"PPO update card vs cpu: {out['update']}")
    if len(out.get("steps", [])) != 2 or out["launches"] == 0:
        raise AssertionError(f"tiny train steps on the card: {out}")
    for metrics in out["steps"]:
        _check_metrics(metrics, ("loss", "reward", "grad_norm"))
    if not out["resume_bit_equal"]:
        raise AssertionError("the resumed run differs from the straight one on the card")
    return out


# ---------------------------------------------------------------------------
# The command line and checkpoints (ROADMAP A.16.1, A.16.3, A.16.4):
# ``python -m consolver_torch <command>`` in this process, through
# ``consolver_torch.__main__.main(argv)``, from hub-layout checkpoints that
# the phase writes from seeded random weights.
# ---------------------------------------------------------------------------

CLI_TEACHER_PROMPTS = SD_PPO_BATCH  # one global batch of sd15_ppo(): a partial batch is dropped
CLI_TEACHER_STEPS = 20  # the teacher set's DDIM steps
CLI_SWEEP_PROMPTS = 16  # the FID streams: a DDIM-20 sweep and a multistep-dpm sweep
CLI_SD_PRESET = "sd15"  # the converted SD components' config preset
CLI_LATENT = 64
CLI_UNET_SHARDS = 2
# FLUX-Kontext through the CLI at full width, depth cut (``reduced``): the
# full-depth DiT and T5-XXL would put 24 GB + 9.5 GB on the disk every run
CLI_FLUX_DOUBLE, CLI_FLUX_SINGLE, CLI_T5_LAYERS = 2, 4, 2
CLI_FLUX_PAIRS = FLUX_PPO_BATCH
CLI_FLUX_RES = 1024
CLI_FLUX_QUANT_STEPS = 2  # the edit that holds the reloaded int4 stack to quantize(bits=4)


def _host_rss_gib():
    """This process's resident memory (VmRSS) in GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no VmRSS in /proc/self/status")


class _HostPeak:
    """The largest resident memory of this process while the block runs,
    sampled every 2 ms by a thread (a host may refuse to reset VmHWM)."""

    def __enter__(self):
        import threading

        self.before = self.peak = _host_rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, _host_rss_gib())
            time.sleep(0.002)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _host_rss_gib())


def _cli(*argv):
    from consolver_torch.__main__ import main as cli

    code = cli(list(argv))
    if code:
        raise AssertionError(f"`python -m consolver_torch {' '.join(argv)}` exited {code}")


def _dir_bytes(path):
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def _write_hub(path, kind, module, dtype, shards=1):
    """``module``'s weights under the hub's key names, in ``dtype``, as
    safetensors (``shards`` files with an index past 1); (bytes, s)."""
    import torch

    from consolver_torch.models import checkpoint as ck
    from consolver_torch.utils.trees import cast_floating

    state = {k: cast_floating(v.detach(), dtype)
             for k, v in ck.hub_state_dict(module, kind).items()}
    total = sum(v.numel() * v.element_size() for v in state.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    largest = max(v.numel() * v.element_size() for v in state.values())
    # each shard but the last holds more than total / shards: ``shards`` files
    ck.save_sharded(state, str(path), max_shard_bytes=None if shards == 1 else
                    -(-total // shards) + largest)
    return _dir_bytes(path), time.perf_counter() - t0


def _timed_component_load(path, kind, default, dtype):
    """One component loaded as the CLIs load it: its seconds, GB/s of the
    files, and the host's peak RSS during the load."""
    import torch

    from consolver_torch.cli.train_sd15 import load_component_module

    with _HostPeak() as host:
        t0 = time.perf_counter()
        module = load_component_module(str(path), kind, default, dtype, "cuda")
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    nbytes = _dir_bytes(path)
    return module, {"bytes": nbytes, "load_s": s, "load_gb_per_s": nbytes / s / 1e9,
                    "host_rss_before_gib": host.before, "host_peak_rss_gib": host.peak,
                    "host_rss_growth_gib": host.peak - host.before}


def _cli_sweep_reference(pipe, prompts, out, steps, solver):
    """The ``generate`` command's sweep, with an in-memory pipeline: the same
    batch generators, ids, noise and call, written as PNGs."""
    import torch

    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.eval.gen_sweep import generate_sweep

    vocab = pipe.text_encoder.cfg.vocab_size

    def generate_batch(generator, batch_prompts):
        ids = torch.as_tensor(tokenize_batch(HashTokenizer(), batch_prompts, 77, vocab_size=vocab),
                              device="cuda")
        noise = torch.randn((len(batch_prompts), CLI_LATENT, CLI_LATENT, 4), device="cuda",
                            generator=generator)
        images, _ = pipe(generator, ids, noise, steps, CFG, solver=solver, record=False)
        return images

    return generate_sweep(generate_batch, prompts, str(out), BATCH, 0, device="cuda")


def _same_pngs(a_dir, b_dir, count):
    import numpy as np

    from consolver_torch.utils.png import read_png

    diffs = []
    for i in range(count):
        a, b = (read_png(str(Path(d) / f"{i:06d}.png")).astype(np.int32) for d in (a_dir, b_dir))
        diffs.append(int(np.abs(a - b).max()))
    return max(diffs)


def _timed_train_steps(trainer_cls):
    """Patch ``trainer_cls.train_step`` to record (num_inference, s) of each
    step, ending in a synchronise; returns (records, undo)."""
    import torch

    records, original = [], trainer_cls.train_step

    def timed(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = original(self, batch)
        torch.cuda.synchronize()
        records.append({"num_inference": metrics["num_inference"],
                        "s": time.perf_counter() - t0, "reward": metrics["reward"],
                        "loss": metrics["loss"]})
        return metrics

    trainer_cls.train_step = timed
    return records, lambda: setattr(trainer_cls, "train_step", original)


def _drawn_steps(seed, step_range, steps):
    """The inference-step counts the trainers draw at steps 0.. (keyed by
    (seed, step), ``PPOStepMixin._num_inference_for_step``)."""
    import random

    return [random.Random(f"{seed}-{s}").randrange(*step_range) for s in range(steps)]


def _launches(fa):
    return fa.flash_attention.launches, dict(fa.flash_attention.launches_by_route)


def _check_cli_launches(fa, want, what):
    launches, by_route = _launches(fa)
    if launches != want or by_route.get("mma") != want:
        raise AssertionError(f"{what}: kernel #1 launched {launches} times ({by_route}), want "
                             f"{want} on mma")
    return {"launches": launches, "launches_by_route": by_route}


def phase_cli(fa, workdir):
    """The command line from checkpoints on disk (see the module docstring,
    phase 19); every command through ``__main__.main`` in this process.  The
    converted SD-1.5 and FLUX-Kontext component directories stay under
    ``workdir`` for the phases after this one (``sd_ckpts``, ``flux_ckpts``)."""
    import contextlib
    import dataclasses
    import io
    import resource

    import numpy as np
    import torch

    from consolver_torch.cli import train_flux as cli_flux
    from consolver_torch.cli import train_sd15 as cli_sd
    from consolver_torch.configs.config import ExperimentConfig, apply_overrides
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.edit_prep import prepare_edit_set
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.models import checkpoint as ck
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.inception import InceptionV3
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.unet_2d import UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.rl.train import PPOTrainer
    from consolver_torch.rl.train_edit import EditPPOTrainer
    from consolver_torch.utils.png import write_png

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    out = {"phase": "cli", "reduced": {
        "flux": f"FLUX-Kontext DiT {CLI_FLUX_DOUBLE} double + {CLI_FLUX_SINGLE} single blocks "
                f"(published 19 + 38), T5-XXL {CLI_T5_LAYERS} layers (published 24); widths "
                "published"}}
    sd_cfg = ExperimentConfig.sd15_ppo()
    tmp = Path(workdir)
    hub, ckpts = tmp / "hub", tmp / "ckpts" / "sd15"

    # 1. a full-width SD-1.5 hub directory in f32 (the UNet in 2 shards),
    #    written from the in-memory bf16 models, converted component by component
    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    unet, text, vae = _sd15_models(gen)
    torch.manual_seed(SEED + 151)  # InceptionV3 keeps PyTorch's default init
    inception = InceptionV3(1000, device="cuda")
    components = {}
    for name, kind, module, shards in (("unet", "unet", unet, CLI_UNET_SHARDS),
                                       ("vae", "vae", vae, 1),
                                       ("text_encoder", "clip_text", text, 1),
                                       ("inception", "inception", inception, 1)):
        nbytes, write_s = _write_hub(hub / name, kind, module, torch.float32, shards)
        dst = ckpts / kind if kind != "inception" else tmp / "ckpts" / "inception"
        t0 = time.perf_counter()
        _cli("convert", "--kind", kind, "--src", str(hub / name), "--dst", str(dst),
             "--config", CLI_SD_PRESET)
        components[kind] = {"hub_bytes": nbytes,
                            "hub_files": len(list((hub / name).glob("*.safetensors"))),
                            "hub_write_s": write_s,
                            "hub_write_gb_per_s": nbytes / write_s / 1e9,
                            "convert_s": time.perf_counter() - t0,
                            "component_bytes": _dir_bytes(dst)}
        shutil.rmtree(hub / name)
    # the CLIs' loader on each float component: f32 files -> bf16 on the card
    for kind, default in (("unet", UNetConfig.sd15()), ("vae", VaeConfig.sd15()),
                          ("clip_text", ClipTextConfig.sd15())):
        loaded, stats = _timed_component_load(ckpts / kind, kind, default, bf16)
        components[kind].update(stats)
        want = {"unet": unet, "vae": vae, "clip_text": text}[kind].state_dict()
        if not _states_equal(loaded.state_dict(), want):
            raise AssertionError(f"{kind} loaded from disk differs from the in-memory model")
        del loaded
    out["components"] = components
    out["process_peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20

    # 2. generate from disk == the in-memory pipeline, bit for bit; 257 launches
    prompts = PROMPTS[:BATCH]
    (tmp / "prompts.txt").write_text("\n".join(prompts) + "\n")
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(),
                               factor_net=cli_sd.make_policy(sd_cfg.factor_net, 0, "cuda"),
                               tokenizer=HashTokenizer(), device="cuda")
    _cli_sweep_reference(pipe, prompts, tmp / "ref_ours", STEPS, "consistencysolver")
    del pipe, unet, text, vae, inception
    _release_card()
    common = ["--pretrained", str(ckpts), "--latent-size", str(CLI_LATENT),
              "--batch-size", str(BATCH)]
    fa.reset_counts()
    t0 = time.perf_counter()
    _cli("generate", "--solver", "consistencysolver", "--steps", str(STEPS),
         "--prompts", str(tmp / "prompts.txt"), "--out", str(tmp / "ours"), *common)
    out["generate"] = {"s": time.perf_counter() - t0,
                       **_check_cli_launches(fa, LAUNCHES_PER_GENERATION, "generate"),
                       "max_levels_vs_in_memory": _same_pngs(tmp / "ours", tmp / "ref_ours",
                                                             BATCH)}
    if out["generate"]["max_levels_vs_in_memory"]:
        raise AssertionError(f"generate from disk differs from the in-memory pipeline: "
                             f"{out['generate']}")

    # 3. a teacher set of one global batch, two PPO steps, a resume and one more
    t0 = time.perf_counter()
    fa.reset_counts()
    _cli("generate-teacher", "--family", "sd", "--pretrained", str(ckpts), "--solver",
         "ddim", "--steps", str(CLI_TEACHER_STEPS), "--max-prompts",
         str(CLI_TEACHER_PROMPTS), "--batch-size", str(BATCH), "--out", str(tmp / "teacher"))
    out["generate_teacher"] = {"s": time.perf_counter() - t0,
                               "samples": len(list((tmp / "teacher").glob("*.npz"))),
                               "launches": fa.flash_attention.launches}
    if out["generate_teacher"]["samples"] != CLI_TEACHER_PROMPTS:
        raise AssertionError(f"teacher set: {out['generate_teacher']}")
    train = ["--preset", "sd15_ppo", "--set", f"model.pretrained_path={ckpts}",
             "--set", f"data.batch_size={CLI_TEACHER_PROMPTS}",
             "--set", f"data.train_data_dir={tmp / 'teacher'}",
             "--set", f"train.output_dir={tmp / 'run'}",
             "--set", f"train.decode_chunk={SD_PPO_DECODE_CHUNK}"]
    records, undo = _timed_train_steps(PPOTrainer)
    try:
        fa.reset_counts()
        t0 = time.perf_counter()
        _cli("train-sd", *train, "--set", f"train.max_train_steps={SD_PPO_TRAIN_STEPS}")
        train_s = time.perf_counter() - t0
        drawn = _drawn_steps(PPO_SEED, SD_PPO_STEP_RANGE, SD_PPO_TRAIN_STEPS + 1)
        want = sum(sd_ppo_launches(n) for n in drawn[:SD_PPO_TRAIN_STEPS])
        out["train_sd"] = {"command_s": train_s, "steps": list(records),
                           **_check_cli_launches(fa, want, "train-sd")}
        first = sorted(p.name for p in (tmp / "run").glob("checkpoint-*"))
        fa.reset_counts()
        _cli("train-sd", *train, "--set", f"train.max_train_steps={SD_PPO_TRAIN_STEPS + 1}")
        out["train_sd_resumed"] = {
            "steps": records[SD_PPO_TRAIN_STEPS:],
            **_check_cli_launches(fa, sd_ppo_launches(drawn[SD_PPO_TRAIN_STEPS]),
                                  "train-sd resumed")}
    finally:
        undo()
    after = sorted(p.name for p in (tmp / "run").glob("checkpoint-*"))
    out["checkpoints"] = after
    if (first != [f"checkpoint-{SD_PPO_TRAIN_STEPS}"]
            or f"checkpoint-{SD_PPO_TRAIN_STEPS + 1}" not in after
            or [r["num_inference"] for r in records] != drawn):
        raise AssertionError(f"train-sd: checkpoints {first} then {after}, steps "
                             f"{records}, drawn {drawn}")
    for r in records:
        _check_metrics(r, ("loss", "reward"))

    # 4. evaluation: consistency of the 8 previews against a DDIM-20
    #    sweep, FID of 16 + 16 images through the converted InceptionV3
    _cli("generate", "--solver", "ddim", "--steps", str(CLI_TEACHER_STEPS), "--max-prompts",
         str(CLI_SWEEP_PROMPTS), "--out", str(tmp / "teacher_png"), *common)
    _cli("generate", "--solver", "multistep-dpm", "--steps", str(STEPS), "--max-prompts",
         str(CLI_SWEEP_PROMPTS), "--out", str(tmp / "dpm_png"), *common)
    _cli("evaluate", "consistency", "--generated", str(tmp / "ours"), "--reference",
         str(tmp / "teacher_png"), "--reward", "image_psnr", "--out", str(tmp / "stats.json"))
    stats = json.loads((tmp / "stats.json").read_text())
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _cli("evaluate", "fid", "--generated", str(tmp / "dpm_png"), "--reference",
             str(tmp / "teacher_png"), "--encoder-ckpt", str(tmp / "ckpts" / "inception"))
    fid = float(re.search(r"'fid': ([^}]+)", printed.getvalue()).group(1))
    out["evaluate"] = {"consistency": {k: stats[k] for k in ("num_scored", "num_errors",
                                                             "mean", "std")},
                       "fid": fid, "fid_s": time.perf_counter() - t0}
    if (stats["num_scored"] != BATCH or stats["num_errors"]
            or not np.isfinite(stats["mean"]) or not np.isfinite(fid)):
        raise AssertionError(f"evaluate: {out['evaluate']}")

    # 5. the int8 hybrid serving checkpoint, reloaded == in-memory quantize()
    _cli("quantize", "--family", "sd", "--pretrained", str(ckpts), "--dst",
         str(tmp / "ckpts" / "sd15_int8"))
    float_pipe = cli_sd.build_pipeline(
        apply_overrides(sd_cfg, {"model.pretrained_path": str(ckpts)}),
        cli_sd.make_policy(sd_cfg.factor_net, 0, "cuda"), "cuda")
    float_pipe.tokenizer = HashTokenizer()
    _cli_sweep_reference(float_pipe.quantize(), prompts, tmp / "ref_int8", STEPS,
                         "consistencysolver")
    del float_pipe
    _release_card()
    fa.reset_counts()
    _cli("generate", "--solver", "consistencysolver", "--steps", str(STEPS), "--prompts",
         str(tmp / "prompts.txt"), "--out", str(tmp / "int8"), "--pretrained",
         str(tmp / "ckpts" / "sd15_int8"), "--latent-size", str(CLI_LATENT),
         "--batch-size", str(BATCH))
    out["int8_generate"] = {
        **_check_cli_launches(fa, LAUNCHES_PER_GENERATION, "int8 generate"),
        "max_levels_vs_in_memory": _same_pngs(tmp / "int8", tmp / "ref_int8", BATCH),
        "unet_bytes": _dir_bytes(tmp / "ckpts" / "sd15_int8" / "unet")}
    if out["int8_generate"]["max_levels_vs_in_memory"]:
        raise AssertionError(f"the reloaded int8 checkpoint differs from quantize(): "
                             f"{out['int8_generate']}")
    shutil.rmtree(tmp / "ckpts" / "sd15_int8")

    # 6. FLUX-Kontext at full width (depth cut) from a bf16 hub directory
    fcfg = dataclasses.replace(FluxConfig.flux_kontext(), num_double_blocks=CLI_FLUX_DOUBLE,
                               num_single_blocks=CLI_FLUX_SINGLE)
    t5_cfg = dataclasses.replace(T5Config.xxl(), num_layers=CLI_T5_LAYERS)
    vae_cfg = VaeConfig(latent_channels=16, scaling_factor=0.3611)
    flux_ckpts = tmp / "ckpts" / "flux"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    flux_components = {}
    for name, kind, build, cfg in (
            ("transformer", "flux", FluxTransformer, fcfg),
            ("t5", "t5", T5Encoder, t5_cfg),
            ("clip_text", "clip_text", ClipTextEncoder, ClipTextConfig.sd15()),
            ("vae", "vae", AutoencoderKL, vae_cfg)):
        module = _random_fill_(build(cfg, device="meta", dtype=bf16).to_empty(device="cuda"),
                               gen)
        nbytes, write_s = _write_hub(hub / name, kind, module, bf16)
        del module
        cfg_file = tmp / f"{name}_preset.json"
        cfg_file.write_text(json.dumps(dataclasses.asdict(cfg)))
        t0 = time.perf_counter()
        _cli("convert", "--kind", kind, "--src", str(hub / name), "--dst",
             str(flux_ckpts / name), "--dtype", "bfloat16", "--config", str(cfg_file))
        flux_components[name] = {"hub_bytes": nbytes, "hub_write_s": write_s,
                                 "convert_s": time.perf_counter() - t0}
        shutil.rmtree(hub / name)
        _release_card()
    out["flux_components"] = flux_components
    rng = np.random.default_rng(SEED + 161)
    (tmp / "edit_src").mkdir()
    for i in range(CLI_FLUX_PAIRS):
        write_png(str(tmp / "edit_src" / f"im{i}.png"),
                  rng.integers(0, 256, EDIT_REF_SHAPE, dtype=np.uint8))
        (tmp / "edit_src" / f"im{i}.txt").write_text(f"make the sky a sunset orange {i}")
    prepared = prepare_edit_set(str(tmp / "edit_src"), str(tmp / "edit_prep"),
                                resolution=CLI_FLUX_RES)
    t0 = time.perf_counter()
    _cli("generate-teacher", "--family", "flux", "--source", str(tmp / "edit_prep"),
         "--pretrained", str(flux_ckpts), "--steps", str(FLUX_TEACHER_STEPS),
         "--batch-size", str(CLI_FLUX_PAIRS), "--out", str(tmp / "flux_teacher"))
    out["flux_teacher"] = {"prepared": prepared, "s": time.perf_counter() - t0,
                           "samples": len(list((tmp / "flux_teacher").glob("*.npz")))}
    if out["flux_teacher"]["samples"] != CLI_FLUX_PAIRS:
        raise AssertionError(f"flux teacher: {out['flux_teacher']}")
    records, undo = _timed_train_steps(EditPPOTrainer)
    try:
        fa.reset_counts()
        _cli("train-flux", "--preset", "flux_ppo",
             "--set", f"model.pretrained_path={flux_ckpts}",
             "--set", f"data.train_data_dir={tmp / 'flux_teacher'}",
             "--set", f"train.output_dir={tmp / 'flux_run'}",
             "--set", "dist.data_parallel=1", "--set", f"data.batch_size={CLI_FLUX_PAIRS}",
             "--set", "train.max_train_steps=1")
    finally:
        undo()
    n = _drawn_steps(PPO_SEED, FLUX_PPO_STEP_RANGE, 1)[0]
    dit = CLI_FLUX_DOUBLE + CLI_FLUX_SINGLE  # one joint attention per block
    want = dit * 2 * n + (2 + 3) * FLUX_VAE_LAUNCHES
    out["train_flux"] = {"steps": records, "dit_launches_per_forward": dit,
                         **_check_cli_launches(fa, want, "train-flux")}
    if ([r["num_inference"] for r in records] != [n]
            or not (tmp / "flux_run" / "checkpoint-1").is_dir()):
        raise AssertionError(f"train-flux: {out['train_flux']}")
    _check_metrics(records[0], ("loss", "reward"))

    # 7. the int4 FLUX serving checkpoint, reloaded == in-memory quantize(bits=4)
    _cli("quantize", "--family", "flux", "--bits", "4", "--pretrained", str(flux_ckpts),
         "--dst", str(tmp / "ckpts" / "flux_int4"))
    flux_cfg = ExperimentConfig.flux_ppo()
    in_memory = cli_flux.build_pipeline(
        apply_overrides(flux_cfg, {"model.pretrained_path": str(flux_ckpts)}),
        cli_sd.make_policy(flux_cfg.factor_net, 0, "cuda"), "cuda").quantize(bits=4)
    loaded = cli_flux.build_pipeline(
        apply_overrides(flux_cfg, {"model.pretrained_path": str(tmp / "ckpts" / "flux_int4")}),
        cli_sd.make_policy(flux_cfg.factor_net, 0, "cuda"), "cuda")
    prompt = ["make the sky a sunset orange"]
    t5_ids = tokenize_batch(HashTokenizer(vocab_size=32128, max_length=128), prompt, 128,
                            vocab_size=loaded.t5.cfg.vocab_size)
    clip_ids = tokenize_batch(HashTokenizer(), prompt, 77, vocab_size=loaded.clip.cfg.vocab_size)
    with np.load(sorted((tmp / "edit_prep").glob("*.npz"))[0]) as z:
        ref = torch.as_tensor(z["ref_image"][None], device="cuda")
    side = CLI_FLUX_RES // 2 ** (len(vae_cfg.block_out_channels) - 1)
    noise = torch.randn((1, side, side, vae_cfg.latent_channels), device="cuda",
                        generator=gen)
    edits = []
    for pipe in (in_memory, loaded):
        edits.append(pipe(torch.Generator(device="cuda").manual_seed(SEED + 162), t5_ids,
                          clip_ids, ref, noise, num_inference_steps=CLI_FLUX_QUANT_STEPS,
                          guidance_scale=FLUX_GUIDANCE, record=False)[0])
    out["int4_flux"] = {
        "dit_bit_equal": _states_equal(in_memory.transformer.state_dict(),
                                    loaded.transformer.state_dict()),
        "vae_bit_equal": _states_equal(in_memory.vae.state_dict(), loaded.vae.state_dict()),
        "edit_bit_equal": bool(torch.equal(edits[0], edits[1])),
        "dit_bytes": _dir_bytes(tmp / "ckpts" / "flux_int4" / "transformer")}
    if not all(out["int4_flux"][k] for k in ("dit_bit_equal", "vae_bit_equal",
                                             "edit_bit_equal")):
        raise AssertionError(f"the reloaded int4 checkpoint differs from quantize(bits=4): "
                             f"{out['int4_flux']}")
    del in_memory, loaded, edits
    shutil.rmtree(tmp / "ckpts" / "flux_int4")
    out["sd_ckpts"], out["flux_ckpts"] = str(ckpts), str(flux_ckpts)
    _release_card()
    out["s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# The rest of the JAX package (ROADMAP A.16.2, A.16.5-A.16.8): images read by
# content (the port's JPEG decoder), the learning checks, ``serve`` from
# ``phase_cli``'s checkpoint directories, LoRA merging into the full-width
# UNet, ``generate-edit`` with the edit scores, and the policy variants.
# ---------------------------------------------------------------------------

JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"
JPEG_TIMED = "big_420_512"
JPEG_REPEATS = 5
LEARNING_CHECKS = ("sd", "sd_quantize", "edit")
LEARNING_MARGIN = 0.05  # the JAX scripts' verdict: last window beats the first by more
LEARNING_TIMEOUT_S = 900
SERVE_CLI_ROUNDS = 2
SERVE_CLI_UP_S = 600  # load + prewarm before the port answers
LORA_RANK = 64
LORA_ALPHA = 32.0
GENERATE_EDIT_SOURCES = ("big_420_512", "progressive_420")
GENERATE_EDIT_BATCHES = (1, 2)


def phase_image_io():
    """Every JPEG fixture of ``tests/data/jpeg`` through ``utils/image``
    (read by its bytes) against the PNG of PIL's decode committed beside it,
    bit for bit; the host time of the 512^2 fixture's decode."""
    import numpy as np

    from consolver_torch.utils.image import decode_image
    from consolver_torch.utils.png import decode_png

    t_phase = time.perf_counter()
    fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
    if len(fixtures) < 8:
        raise AssertionError(f"only {len(fixtures)} JPEG fixtures under {JPEG_FIXTURES}")
    shapes = {}
    for path in fixtures:
        got = decode_image(path.read_bytes())
        want = decode_png(path.with_suffix(".png").read_bytes())
        if got.shape != want.shape or not np.array_equal(got, want):
            diff = (np.abs(got.astype(int) - want.astype(int)).max()
                    if got.shape == want.shape else f"{got.shape} vs {want.shape}")
            raise AssertionError(f"{path.name} decodes unlike PIL: {diff}")
        shapes[path.stem] = list(got.shape)
    raw = (JPEG_FIXTURES / f"{JPEG_TIMED}.jpg").read_bytes()
    times = []
    for _ in range(JPEG_REPEATS):
        t0 = time.perf_counter()
        img = decode_image(raw)
        times.append(time.perf_counter() - t0)
    median = sorted(times)[len(times) // 2]
    out = {"phase": "image_io", "bit_equal_fixtures": shapes,
           "timed": {"fixture": JPEG_TIMED, "jpeg_bytes": len(raw),
                     "decode_ms_median": 1e3 * median, "decode_ms_min": 1e3 * min(times),
                     "rgb_mb_per_s": img.nbytes / median / 1e6,
                     "jpeg_mb_per_s": len(raw) / median / 1e6, "repeats": JPEG_REPEATS},
           "s": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    return out


RESIZE_SIZE = 1024
RESIZE_SOURCES = [(672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328), (832, 1248),
                  (880, 1184), (944, 1104), (1024, 1024), (1104, 944), (1184, 880), (1248, 832),
                  (1328, 800), (1392, 752), (1456, 720), (1504, 688), (1568, 672)]
RESIZE_HOST_REPEATS = 2


def _resize_bytes(rz, h, w, size):
    """The kernel's bytes: the uint8 source and the window tables read once,
    the float32 crop written once (the uint8 scratch between the passes is
    the kernel's own and is not counted)."""
    width, height, left, top = rz.crop_window(h, w, size)
    tables = sum(t.nbytes for in_size, out_size, offset in ((w, width, left), (h, height, top))
                 if out_size != in_size for t in rz.window_tables(in_size, out_size, offset, size))
    return h * w * 3 + tables + size * size * 3 * 4


def phase_resize(rz):
    """The reference crop-resize kernel against the host path at every
    Kontext-preferred source size: bit-equal once, then the kernel's device
    time, the engine's upload-and-launch time and the host path's time."""
    import numpy as np
    import torch

    from consolver_torch.data.edit_prep import center_crop_resize

    t_phase = time.perf_counter()
    rows = []
    for h, w in RESIZE_SOURCES:
        img = np.random.default_rng(h * 7 + w).integers(0, 256, (h, w, 3), np.uint8)
        host_s = []
        for _ in range(RESIZE_HOST_REPEATS):
            t0 = time.perf_counter()
            want = center_crop_resize(img, RESIZE_SIZE) * 2.0 - 1.0
            host_s.append(time.perf_counter() - t0)
        out = torch.empty((RESIZE_SIZE, RESIZE_SIZE, 3), dtype=torch.float32, device="cuda")
        rz.reference_into(img, RESIZE_SIZE, out)
        if not torch.equal(out.cpu(), torch.from_numpy(want)):
            raise AssertionError(f"resize kernel at {h}x{w} differs from the host path: max "
                                 f"{(out.cpu() - torch.from_numpy(want)).abs().max().item()}")
        src = torch.from_numpy(img).cuda()
        kernel_ms = _graph_ms(lambda: rz.center_crop_resize(src, RESIZE_SIZE, out=out))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            rz.reference_into(img, RESIZE_SIZE, out)
        torch.cuda.synchronize()
        call_ms = 1e3 * (time.perf_counter() - t0) / 5
        nbytes = _resize_bytes(rz, h, w, RESIZE_SIZE)
        bound_ms = nbytes / (HBM_TBPS * 1e12) * 1e3
        width, height, left, top = rz.crop_window(h, w, RESIZE_SIZE)
        rows.append({"source": [h, w], "resized": [height, width],
                     "taps": [rz.window_tables(n, m, o, RESIZE_SIZE)[1].shape[1] if m != n else 0
                              for n, m, o in ((w, width, left), (h, height, top))],
                     "bit_equal": True, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "kernel_over_bound": kernel_ms / bound_ms,
                     "upload_and_launch_ms": call_ms, "host_ms": 1e3 * min(host_s),
                     "bytes": nbytes})
    out = {"phase": "resize", "size": RESIZE_SIZE, "rows": rows,
           "host_ms_mean": sum(r["host_ms"] for r in rows) / len(rows),
           "upload_and_launch_ms_mean": sum(r["upload_and_launch_ms"] for r in rows) / len(rows),
           "kernel_ms_mean": sum(r["kernel_ms"] for r in rows) / len(rows),
           "s": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    return out


def learning_worker(check: str) -> int:
    """One learning check on the card in a process of its own (started by
    :func:`start_learning_checks`): the check's lines, then its result as
    the last line (JSON)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from consolver_torch.cli import learning_check, learning_check_edit
    from consolver_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 tiny stacks, as the tiny phases
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_counts()
    marks = {}

    def log(line):
        if line == "teacher built":
            marks["teacher"] = time.perf_counter()
        print(line, flush=True)

    t0 = time.perf_counter()
    if check == "edit":
        first, last, delta, rewards = learning_check_edit.run(device="cuda", log=log)
    else:
        first, last, delta, rewards = learning_check.run(quantize=check == "sd_quantize",
                                                         device="cuda", log=log)
    torch.cuda.synchronize()
    end = time.perf_counter()
    print(json.dumps({"check": check, "first": first, "last": last, "delta": delta,
                      "steps": len(rewards), "finite": bool(np.isfinite(rewards).all()),
                      "teacher_s": marks["teacher"] - t0,
                      "s_per_step": (end - marks["teacher"]) / len(rewards),
                      "launches": fa.flash_attention.launches,
                      "launches_by_route": dict(fa.flash_attention.launches_by_route)}),
          flush=True)
    return 0


def start_learning_checks(workdir):
    """The three learning checks (SD, SD with the int8 rollout, FLUX), each
    in a process of its own on the card, started together: they run beside
    ``phase_cli``, whose time is the disk's and the host's."""
    procs, logs = {}, {}
    for check in LEARNING_CHECKS:
        logs[check] = Path(workdir) / f"learning_{check}.log"
        with open(logs[check], "w") as log:
            procs[check] = subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, chip_smoke; sys.exit(chip_smoke.learning_worker(sys.argv[1]))",
                 check], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return {"procs": procs, "logs": logs, "t0": time.perf_counter()}


def stop_learning_checks(started):
    for proc in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def phase_learning(started):
    """The learning checks' results: each printed "LEARNING" (its delta
    above 0.05), its rewards are finite, and kernel #1 ran on the "fma"
    route (f32) and nowhere else."""
    t_wait = time.perf_counter()
    checks = {}
    for check, proc in started["procs"].items():
        left = LEARNING_TIMEOUT_S - (time.perf_counter() - started["t0"])
        try:
            code = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired as err:
            raise AssertionError(f"learning check {check} ran past {LEARNING_TIMEOUT_S} s") from err
        lines = started["logs"][check].read_text().strip().splitlines()
        if code != 0 or not lines:
            raise AssertionError(f"learning check {check} exited {code}: {lines[-30:]}")
        result = json.loads(lines[-1])
        routes = result["launches_by_route"]
        if ("LEARNING" not in lines or not result["delta"] > LEARNING_MARGIN
                or not result["finite"] or result["launches"] == 0
                or routes.get("fma") != result["launches"]):
            raise AssertionError(f"learning check {check}: {result}, {lines[-3:]}")
        checks[check] = result
    out = {"phase": "learning", "checks": checks,
           "wall_s": time.perf_counter() - started["t0"],
           "waited_after_cli_s": time.perf_counter() - t_wait,
           "overlapped_with": "phase_cli"}
    print(json.dumps(out), flush=True)
    return out


def phase_serve_cli(fa, cli):
    """``python -m consolver_torch serve --family both`` in this process (the
    CLI's ``main``) on ``phase_cli``'s SD-1.5 and depth-cut FLUX-Kontext
    directories, batch shapes 1 and 8, adaptive flush, prewarm at 8 steps:
    rounds of 8 concurrent generates, a refine and an edit over HTTP, then a
    SIGTERM while a batch of 8 is in flight (taken from the queue, not yet
    answered): all 8 answered before ``main`` returns; a deterministic
    request bit-equal to an in-memory engine over the same weights."""
    import base64
    import os
    import signal
    import threading
    import urllib.request

    import numpy as np
    import torch

    from consolver_torch.cli import serve as cli_serve
    from consolver_torch.cli import train_sd15 as cli_sd
    from consolver_torch.configs.config import ExperimentConfig
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer
    from consolver_torch.dist.launch import free_port
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.serve import GenerationRequest, InferenceEngine
    from consolver_torch.utils import png

    _release_card()
    t_phase = time.perf_counter()
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    argv = ["--family", "both", "--pretrained", cli["sd_ckpts"], "--edit-pretrained",
            cli["flux_ckpts"], "--batch-sizes", f"1,{BATCH}", "--adaptive-flush", "--flush-ms",
            str(SERVE_FLUSH_MS), "--prewarm", str(STEPS), "--port", str(port)]
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy for localhost
    dit_blocks = CLI_FLUX_DOUBLE + CLI_FLUX_SINGLE
    edit_launches = dit_blocks * FLUX_STEPS + 2 * FLUX_VAE_LAUNCHES
    client = {}

    def get(path):
        with opener.open(base + path, timeout=30) as r:
            return json.load(r)

    def gen_body(i, **kw):
        return {"prompt": PROMPTS[i % len(PROMPTS)], "seed": 4000 + i, "num_inference_steps": STEPS,
                "guidance_scale": CFG, **kw}

    def concurrent(bodies):
        barrier = threading.Barrier(len(bodies))

        def one(body):
            barrier.wait()
            return _post(opener, base + "/v1/generate", body)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            results = list(pool.map(one, bodies))
        return results, time.perf_counter() - t0

    def drive():
        try:
            deadline = time.perf_counter() + SERVE_CLI_UP_S
            while True:
                try:
                    if get("/healthz") == {"ok": True}:
                        break
                except OSError:
                    pass
                if time.perf_counter() > deadline or not serving.is_set():
                    raise AssertionError(f"serve did not answer within {SERVE_CLI_UP_S} s")
                time.sleep(0.2)
            client["startup_s"] = time.perf_counter() - t_phase
            # rounds of 8 concurrent generates: kernel #1 257 times per batch formed
            rounds, latencies = [], []
            fa.reset_counts()
            before = get("/v1/stats")["generate"]["batches"]
            for r in range(SERVE_CLI_ROUNDS):
                results, wall = concurrent([gen_body(r * BATCH + i) for i in range(BATCH)])
                for code, body, sec in results:
                    _check_image(_image(_ok(code, body, "serve generate")), 512, "serve generate")
                    latencies.append(sec)
                rounds.append(wall)
            torch.cuda.synchronize()
            batches = get("/v1/stats")["generate"]["batches"] - before
            client["generate"] = {
                "rounds_s": rounds, "batches": batches,
                "img_per_s": SERVE_CLI_ROUNDS * BATCH / sum(rounds),
                "latency_p50_s": _percentile(latencies, 0.5),
                "latency_p95_s": _percentile(latencies, 0.95),
                **dict(zip(("launches", "launches_by_route"),
                           _check_launches(fa, batches * LAUNCHES_PER_GENERATION,
                                           "serve generate rounds")))}
            code, body, _ = _post(opener, base + "/v1/generate", gen_body(99, deterministic=True))
            client["deterministic"] = _image(_ok(code, body, "serve deterministic"))
            code, body, sec = _post(opener, base + "/v1/refine", {"prompt": PROMPTS[7], "seed": 7})
            _check_image(_image(_ok(code, body, "serve refine")), 512, "serve refine")
            client["refine_s"] = sec
            ref = np.random.default_rng(SEED + 190).integers(0, 256, EDIT_REF_SHAPE, dtype=np.uint8)
            fa.reset_counts()
            code, body, sec = _post(opener, base + "/v1/edit", {
                "instruction": "make the sky a sunset orange", "seed": 5,
                "image_png_b64": base64.b64encode(png.encode_png(ref)).decode()})
            _check_image(_image(_ok(code, body, "serve edit")), CLI_FLUX_RES, "serve edit")
            torch.cuda.synchronize()
            client["edit"] = {"s": sec, **dict(zip(("launches", "launches_by_route"),
                                                   _check_launches(fa, edit_launches,
                                                                   "serve edit")))}
            # SIGTERM with a batch in flight: all 8 requests taken from the
            # queue into a batch (queued requests would be failed by the
            # drain, as in the JAX engine), not all of them answered yet;
            # deterministic requests pin one batch shape, so the 8 ride together
            engine = client["engines"][0]
            stats = get("/v1/stats")["generate"]
            want_requests, done_before = stats["requests"] + BATCH, stats["completed"]
            with ThreadPoolExecutor(max_workers=BATCH) as pool:
                futs = [pool.submit(_post, opener, base + "/v1/generate",
                                    gen_body(200 + i, deterministic=True)) for i in range(BATCH)]
                while (get("/v1/stats")["generate"]["requests"] < want_requests
                       or not engine._queue.empty() or engine._pending):
                    time.sleep(0.005)
                client["sigterm_at"] = time.perf_counter()
                os.kill(os.getpid(), signal.SIGTERM)
                client["in_flight"] = BATCH - (engine.stats()["completed"] - done_before)
                drained = [f.result() for f in futs]
            client["drained_codes"] = [code for code, _, _ in drained]
            if client["in_flight"] < 1:
                raise AssertionError("the batch finished before SIGTERM: nothing was in flight")
            for code, body, _ in drained:
                _check_image(_image(_ok(code, body, "drained generate")), 512, "drained generate")
        except BaseException as err:  # noqa: BLE001  (re-raised by the phase after main returns)
            client["error"] = err
            # stop a server that answered (its SIGTERM handler is installed): main returns
            if "startup_s" in client and "sigterm_at" not in client and serving.is_set():
                os.kill(os.getpid(), signal.SIGTERM)

    real_build = cli_serve.build_server

    def capture_build(args):  # the engines, for the SIGTERM gate's view of the queue
        server, engines, descs = real_build(args)
        client["engines"] = engines
        return server, engines, descs

    old_handler = signal.getsignal(signal.SIGTERM)
    serving = threading.Event()  # set while cli_serve.main runs
    serving.set()
    thread = threading.Thread(target=drive, name="serve-cli-client", daemon=True)
    thread.start()
    cli_serve.build_server = capture_build
    try:
        cli_serve.main(argv)
    finally:
        serving.clear()
        cli_serve.build_server = real_build
        signal.signal(signal.SIGTERM, old_handler)
    exited_s = time.perf_counter() - client.get("sigterm_at", time.perf_counter())
    thread.join(timeout=600)
    if "error" in client:
        raise AssertionError(f"serve CLI client: {client['error']!r}") from client["error"]
    if thread.is_alive():
        raise AssertionError("serve CLI client did not finish")
    try:
        with opener.open(base + "/healthz", timeout=5):
            raise AssertionError("the server still answers after SIGTERM")
    except OSError:
        pass

    # the same weights in memory (phase_cli's seeded models), one engine
    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    unet, text, vae = _sd15_models(gen)
    sd_cfg = ExperimentConfig.sd15_ppo()
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(),
                               factor_net=cli_sd.make_policy(sd_cfg.factor_net, 0, "cuda"),
                               tokenizer=HashTokenizer(), device="cuda")
    with InferenceEngine(pipe, batch_size=BATCH, batch_sizes=(1, BATCH),
                         latent_size=CLI_LATENT) as engine:
        want = engine.generate(GenerationRequest(**gen_body(99, deterministic=True)), timeout=600)
    if not np.array_equal(client["deterministic"], want):
        raise AssertionError("serve CLI's deterministic image differs from the in-memory engine's: "
                             f"max {_max_diff(client['deterministic'], want)} levels")
    del pipe, unet, text, vae
    _release_card()
    out = {"phase": "serve_cli", "argv": argv, "startup_s": client["startup_s"],
           "generate": client["generate"], "refine_s": client["refine_s"], "edit": client["edit"],
           "deterministic_bit_equal_in_memory": True,
           "sigterm": {"requests": BATCH, "in_flight": client["in_flight"],
                       "answered": client["drained_codes"].count(200),
                       "main_returned_after_s": exited_s},
           "reduced": cli["reduced"], "s": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    return out


def phase_lora(fa):
    """A random rank-64 LoRA on every attention projection of the
    full-width SD-1.5 UNet (128 pairs), as a peft file and as a kohya file of
    the same pairs, merged with ``merge_lora``: the two merges bit-equal,
    each merged weight within one bf16 ulp of ``W + (alpha / r) B A`` taken
    layer by layer as one f32 ``addmm`` on the card and cast to bf16; then
    one generation of 8 with the merged UNet (257 launches, all "mma")."""
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.models.lora import merge_lora
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    _release_card()
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 170)
    unet, text, vae = _sd15_models(gen)
    sd = unet.state_dict()
    targets = sorted(k[: -len(".weight")] for k in sd
                     if re.search(r"\.attn[12]\.(to_q|to_k|to_v|to_out\.0)\.weight$", k))
    peft, kohya, pairs = {}, {}, {}
    for t in targets:
        out_dim, in_dim = sd[t + ".weight"].shape
        down = 0.02 * torch.randn((LORA_RANK, in_dim), device="cuda", generator=gen)
        up = 0.02 * torch.randn((out_dim, LORA_RANK), device="cuda", generator=gen)
        alpha = torch.tensor(LORA_ALPHA)
        peft.update({f"{t}.lora_A.weight": down, f"{t}.lora_B.weight": up, f"{t}.alpha": alpha})
        flat = "lora_unet_" + t.replace(".", "_")
        kohya.update({f"{flat}_lora_down.weight": down, f"{flat}_lora_up.weight": up,
                      f"{flat}.alpha": alpha})
        pairs[t] = (down, up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = merge_lora(sd, peft)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merged_kohya = merge_lora(sd, kohya)
    if not all(torch.equal(merged[k], merged_kohya[k]) for k in sd):
        raise AssertionError("the kohya LoRA merges unlike the peft LoRA of the same pairs")
    worst = 0.0  # bf16 ulps between merge_lora and a layer-by-layer f32 addmm, cast alike
    for t, (down, up) in pairs.items():
        want = torch.addmm(sd[t + ".weight"].float(), up, down,
                           alpha=LORA_ALPHA / LORA_RANK).to(torch.bfloat16).float()
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
        worst = max(worst, float(((merged[t + ".weight"].float() - want).abs() / ulp).max()))
    if worst > 1.0:
        raise AssertionError(f"merged weights {worst} bf16 ulps off W + (alpha/r) B A")
    changed = sum(not torch.equal(sd[k], merged[k]) for k in sd)
    unet.load_state_dict(merged)
    policy = FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, family="sd"),
                       device="cuda")
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=policy,
                               tokenizer=HashTokenizer(), device="cuda")
    ids = tokenize_batch(HashTokenizer(), PROMPTS[:BATCH], 77)
    noise = torch.randn((BATCH, 64, 64, 4), device="cuda", generator=gen)
    fa.reset_counts()
    t0 = time.perf_counter()
    images, _ = pipe(torch.Generator(device="cuda").manual_seed(SEED + 171), ids, noise,
                     num_inference_steps=STEPS, guidance_scale=CFG, record=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches, by_route = _check_launches(fa, LAUNCHES_PER_GENERATION, "LoRA-merged generation")
    lo, hi = float(images.min()), float(images.max())
    if tuple(images.shape) != (BATCH, 512, 512, 3) or not 0.0 <= lo <= hi <= 1.0:
        raise AssertionError(f"LoRA-merged images: {tuple(images.shape)} in [{lo}, {hi}]")
    del pipe, policy, unet, text, vae, sd, merged, merged_kohya, peft, kohya, pairs
    _release_card()
    out = {"phase": "lora", "pairs": len(targets), "rank": LORA_RANK, "alpha": LORA_ALPHA,
           "weights_changed": changed, "merge_s": merge_s,
           "max_bf16_ulps_vs_f32_addmm": worst, "kohya_bit_equal_peft": True,
           "generation": {"s": gen_s, "launches": launches, "launches_by_route": by_route},
           "s": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    return out


def phase_generate_edit(fa, cli, workdir):
    """``python -m consolver_torch generate-edit`` over a kontext-bench-shaped
    source (a ``metadata.jsonl`` and two of the JPEG fixtures, the first
    keyed) on ``phase_cli``'s depth-cut FLUX-Kontext directory at 1024^2,
    at ``--batch-size`` 1 and 2: the folder layout, every example scored by
    ``score_results`` with a plain PSNR scorer and no error, the noise the
    command drew for each example the same at both batch sizes, and kernel
    #1's launches per pipeline call."""
    import numpy as np
    import torch

    from consolver_torch.cli import generate_edit as cli_edit
    from consolver_torch.eval.edit_scores import list_examples, score_results

    _release_card()
    t_phase = time.perf_counter()
    src = Path(workdir) / "kontext_src"
    (src / "images").mkdir(parents=True)
    with open(src / "metadata.jsonl", "w") as f:
        for i, name in enumerate(GENERATE_EDIT_SOURCES):
            shutil.copy(JPEG_FIXTURES / f"{name}.jpg", src / "images" / f"{name}.jpg")
            record = {"file_name": f"images/{name}.jpg",
                      "instruction": f"make it look like winter {i}"}
            if i == 0:
                record["key"] = "kontext_0000"
            f.write(json.dumps(record) + "\n")
    want_names = sorted(["kontext_0000", "00001_make_it_look_like_winter_1"])
    drawn = {}
    real_noise = cli_edit.example_noise

    def recording_noise(seed, indices, shape):
        noise = real_noise(seed, indices, shape)
        for j, i in enumerate(indices):
            drawn[batch].setdefault(i, noise[j].clone())
        return noise

    def psnr(ref, instruction, edited):
        return float(10 * np.log10(1.0 / max(float(np.mean((ref - edited) ** 2)), 1e-10)))

    dit_blocks = CLI_FLUX_DOUBLE + CLI_FLUX_SINGLE
    runs = {}
    cli_edit.example_noise = recording_noise
    try:
        for batch in GENERATE_EDIT_BATCHES:
            drawn[batch] = {}
            out_dir = Path(workdir) / f"edits_bs{batch}"
            calls = -(-len(GENERATE_EDIT_SOURCES) // batch)
            fa.reset_counts()
            t0 = time.perf_counter()
            _cli("generate-edit", "--source", str(src), "--out", str(out_dir), "--pretrained",
                 cli["flux_ckpts"], "--steps", str(FLUX_STEPS), "--batch-size", str(batch),
                 "--resolution", str(CLI_FLUX_RES))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, by_route = _check_launches(
                fa, calls * (dit_blocks * FLUX_STEPS + 2 * FLUX_VAE_LAUNCHES),
                f"generate-edit --batch-size {batch}")
            names = sorted(p.name for p in out_dir.iterdir())
            if names != want_names or len(list_examples(str(out_dir))) != len(want_names):
                raise AssertionError(f"generate-edit --batch-size {batch} wrote {names}")
            stats = score_results(str(out_dir), psnr)
            if (stats["num_scored"] != len(want_names) or stats["num_errors"]
                    or not np.isfinite(stats["mean"])):
                raise AssertionError(f"score_results: {stats}")
            runs[batch] = {"s": wall, "pipeline_calls": calls, "launches": launches,
                           "launches_by_route": by_route, "scores": stats}
    finally:
        cli_edit.example_noise = real_noise
    for i in range(len(GENERATE_EDIT_SOURCES)):
        if not torch.equal(drawn[1][i], drawn[2][i]):
            raise AssertionError(f"example {i}'s noise depends on --batch-size")
    _release_card()
    out = {"phase": "generate_edit", "examples": len(GENERATE_EDIT_SOURCES),
           "folders": want_names, "noise_same_at_batch_1_and_2": True,
           "by_batch_size": {str(k): v for k, v in runs.items()}, "reduced": cli["reduced"],
           "s": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    return out


def phase_policy_variants():
    """``ContinuousFactorNet`` and ``MuNet`` on the card against the CPU with
    the same weights and inputs (f32, TF32 off): means, stds, densities,
    entropies and log-probs within SLICE_TOL of each output's largest value;
    the card's samples inside the bounds and on the grid."""
    import torch

    from consolver_torch.policy.continuous import ContinuousFactorNet, ContinuousFactorNetConfig
    from consolver_torch.policy.mu_net import MuNet

    t_phase = time.perf_counter()
    torch.manual_seed(SEED + 180)
    cfg = ContinuousFactorNetConfig(order_dim=4, scaler_dim=0, family="sd", use_conv=True)
    cpu = ContinuousFactorNet(cfg, device="cpu")
    mu_cpu = MuNet(device="cpu")
    with torch.no_grad():
        cpu.head.weight.normal_(0, 0.02)
        cpu.log_std.normal_(-1.0, 0.1)
    card, mu_card = copy.deepcopy(cpu).to("cuda"), copy.deepcopy(mu_cpu).to("cuda")
    conds = {"x": torch.rand((64, 2)) * 999, "epsilon": torch.randn((64, 4, 4, 8, 8))}
    actions, _ = cpu.sample_action(conds, torch.Generator().manual_seed(1))
    x = torch.rand((64, 1)) * 4 - 2
    mu_actions, _ = mu_cpu.sample_action(x, torch.Generator().manual_seed(2))

    def on_card(tree):
        return {k: v.cuda() for k, v in tree.items()}

    with torch.no_grad():
        pairs = {
            "mean_std": (cpu.dist(conds), card.dist(on_card(conds))),
            "density_entropy": (cpu.get_action_probs(conds, actions),
                                card.get_action_probs(on_card(conds), actions.cuda())),
            "mu_log_probs": ((mu_cpu.log_probs(x),), (mu_card.log_probs(x.cuda()),)),
            "mu_probs_entropy": (mu_cpu.get_action_probs(x, mu_actions),
                                 mu_card.get_action_probs(x.cuda(), mu_actions.cuda())),
        }
        errs = {}
        for name, (want, got) in pairs.items():
            errs[name] = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
                             for w, g in zip(want, got))
        sampled, _ = card.sample_action(on_card(conds), torch.Generator("cuda").manual_seed(3))
        mu_sampled, _ = mu_card.sample_action(x.cuda(), torch.Generator("cuda").manual_seed(4))
    if max(errs.values()) > SLICE_TOL:
        raise AssertionError(f"policy variants card vs CPU: {errs}")
    in_bounds = bool(((sampled >= card.low) & (sampled <= card.high)).all())
    on_grid = bool((mu_sampled[:, None] == mu_card.action_values[None]).any(dim=1).all())
    if not (in_bounds and on_grid):
        raise AssertionError(f"samples: in bounds {in_bounds}, on the grid {on_grid}")
    out = {"phase": "policy_variants", "max_rel_err": errs, "tolerance": SLICE_TOL,
           "s": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# The quantized configurations (ROADMAP A.11): the W8A8 int8 and W4A16 int4
# layers of ``kernels/quant.py``.  Their integer products are cuBLASLt's int8
# GEMM (``torch._int_mm``), a library call the JAX package also leaves to XLA;
# every attention stays on kernel #1.
# ---------------------------------------------------------------------------

# (name, kind, input shape, in, out, kernel size, stride, padding): the
# UNet's level-1 and level-2 resnet convolutions, the level-1 downsample
# (after its (0, 1) pad) and an up-block 1x1 shortcut at UNet batch 16, the
# FLUX ff_net_0 over the 8704 joint tokens and a FLUX modulation at batch 1
# (one row, padded to the GEMM's 17).
QUANT_OPS_CASES = [
    ("unet_l1_conv3x3", "conv", (2 * BATCH, 640, 32, 32), 640, 640, 3, 1, 1),
    ("unet_l2_conv3x3", "conv", (2 * BATCH, 1280, 16, 16), 1280, 1280, 3, 1, 1),
    ("unet_l1_downsample", "conv", (2 * BATCH, 640, 33, 33), 640, 640, 3, 2, 0),
    ("unet_l1_shortcut_1x1", "conv", (2 * BATCH, 960, 32, 32), 960, 640, 1, 1, 0),
    ("flux_ff_net_0", "dense", (8704, 3072), 3072, 12288, None, None, None),
    ("flux_modulation_b1", "dense", (1, 3072), 3072, 18432, None, None, None),
]
# int4 (W4A16) vs its plain version: the card dequantizes to bf16 and runs a
# bf16 GEMM with f32 accumulation, then a bf16 bias add; the plain version
# takes the same bf16 weights through an f32 GEMM and rounds where the card
# does, so only the f32 summation order differs (a last-bit flip of the
# GEMM's bf16 rounding).  Held at one bf16 ulp of the largest output.
INT4_TOL = 2.0**-7
QUANT_SKIP = {"hybrid": (0,), "uniform": ()}


def _int8_gemm_bound(m, k, n, in_bytes, out_bytes):
    """Least ms of an int8 GEMM of [m, k] x [k, n]: int8 operations at the
    card's int8 peak, or the activations read once (``in_bytes`` each), the
    int8 kernel read once and the output written once."""
    op_ms = 2.0 * m * k * n / (INT8_TOPS * 1e12) * 1e3
    byte_ms = (m * k * in_bytes + k * n + m * n * out_bytes) / (HBM_TBPS * 1e12) * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def phase_quant_ops():
    """The int8 and int4 layers at main-path shapes on the card: the int8
    GEMM's int32 accumulators against the plain version's (f64 products,
    exact), the layer's output against the plain accumulators dequantized
    the same way (bit-equal), int4 against f32 within ``INT4_TOL``; times of
    the layer, its parts and the bf16 layer at the same shape."""
    _release_card()
    import torch
    import torch.nn.functional as F
    from torch import nn

    from consolver_torch.kernels import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    bf16 = torch.bfloat16
    rows = []
    with torch.inference_mode():
        for name, kind, shape, cin, cout, k, stride, pad in QUANT_OPS_CASES:
            x = torch.randn(shape, device="cuda", generator=gen).to(bf16)
            if kind == "dense":
                flt = _random_fill_(nn.Linear(cin, cout, device="cuda", dtype=bf16), gen)
                layer = tq.quantize_like(tq.Int8Linear(cin, cout), flt)
                xq, a_scale = tq._quantize_act(x, per_token=True)
                lhs, rhs = xq, layer.kernel
                quant_fn = lambda: tq._quantize_act(x, per_token=True)  # noqa: E731
                im2col_fn = None
                bf16_fn = lambda: F.linear(x, flt.weight, flt.bias)  # noqa: E731
                out_shape, deq_scale = (shape[0], cout), a_scale
            else:
                flt = _random_fill_(nn.Conv2d(cin, cout, k, stride, pad, device="cuda",
                                              dtype=bf16), gen)
                layer = tq.quantize_like(tq.Int8Conv2d(cin, cout, k, stride, pad), flt)
                xh = x.permute(0, 2, 3, 1)
                b, h, w, _ = xh.shape
                pads = tq.conv_pads(pad, k, k, h, w, (stride, stride))
                xq, a_scale = tq._quantize_act(xh, per_token=False)
                lhs = tq.im2col_int8(xq, k, k, (stride, stride), pads)
                rhs = layer.kernel.reshape(cout, -1)
                quant_fn = lambda: tq._quantize_act(xh, per_token=False)  # noqa: E731
                im2col_fn = lambda: tq.im2col_int8(xq, k, k, (stride, stride), pads)  # noqa: E731
                bf16_fn = lambda: flt(x)  # noqa: E731
                ho, wo = (h + sum(pads[0]) - k) // stride + 1, (w + sum(pads[1]) - k) // stride + 1
                out_shape, deq_scale = (b, ho * wo, cout), a_scale.reshape(b, 1, 1)
            before = tq.int_mm.launches
            acc = tq.int_mm(lhs, rhs)
            launched = tq.int_mm.launches - before
            acc_plain = tq.int_mm_reference(lhs, rhs)
            out = layer(x)
            ref = tq._dequantize(acc_plain.reshape(out_shape), deq_scale, layer.kernel_scale,
                                 layer.bias, bf16)
            if kind == "conv":
                ref = ref.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)
            row = {
                "case": name, "kind": kind, "x": list(shape), "gemm": [lhs.shape[0], lhs.shape[1], cout],
                "int_mm_launches": launched, "acc_equal": bool(torch.equal(acc, acc_plain)),
                "out_bit_equal": bool(torch.equal(out, ref)),
                "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                "ms": _time_ms(lambda: layer(x), 20, warmup=3),
                "gemm_ms": _time_ms(lambda: tq.int_mm(lhs, rhs), 20, warmup=3),
                "quant_ms": _time_ms(quant_fn, 20, warmup=3),
                "dequant_ms": _time_ms(lambda: tq._dequantize(acc.reshape(out_shape), deq_scale,
                                                              layer.kernel_scale, layer.bias, bf16),
                                       20, warmup=3),
                "bf16_ms": _time_ms(bf16_fn, 20, warmup=3),
                "plain_ms": _time_ms(lambda: tq.int_mm_reference(lhs, rhs), 3),
            }
            if im2col_fn is not None:
                row["im2col_ms"] = _time_ms(im2col_fn, 20, warmup=3)
            row["act_quant_share"] = row["quant_ms"] / row["ms"]
            row["ms_over_bf16"] = row["ms"] / row["bf16_ms"]
            row["gemm_bound_ms"], row["gemm_bound_by"] = _int8_gemm_bound(
                lhs.shape[0], lhs.shape[1], cout, 1, 4)
            if kind == "dense":  # the same projection with 4-bit weights
                layer4 = tq.quantize_like(tq.Int4Linear(cin, cout), flt)
                out4 = layer4(x)
                w4 = tq.dequantize_int4(layer4.kernel_packed, layer4.kernel_scale, bf16)
                ref4 = (x.float() @ w4.float()).to(bf16) + layer4.bias.to(bf16)
                row["int4"] = {
                    "err_over_max_ref": ((out4.float() - ref4.float()).abs().max()
                                         / ref4.float().abs().max()).item(),
                    "tol": INT4_TOL, "ms": _time_ms(lambda: layer4(x), 20, warmup=3),
                    "dequant_ms": _time_ms(lambda: tq.dequantize_int4(
                        layer4.kernel_packed, layer4.kernel_scale, bf16), 20, warmup=3),
                    "bytes": tq.module_bytes(layer4), "int8_bytes": tq.module_bytes(layer),
                    "bf16_bytes": tq.module_bytes(flt),
                }
            print(json.dumps({"phase": "quant_ops", **row}), flush=True)
            if launched != 1 or not row["acc_equal"] or not row["out_bit_equal"]:
                raise AssertionError(f"int8 {name}: {row}")
            if kind == "dense" and not row["int4"]["err_over_max_ref"] <= INT4_TOL:
                raise AssertionError(f"int4 {name}: {row['int4']}")
            rows.append(row)
            del x, flt, layer, lhs, rhs, acc, acc_plain, out, ref
    torch.cuda.empty_cache()
    return rows


def phase_int8_sd(fa):
    """SD-1.5 through ``TextToImagePipeline.quantize()``: the hybrid (UNet
    level 0 bf16) and uniform int8, each at batch 8, 8 steps, 512^2, CFG 3:
    a check generation (kernel #1 257 times, all "mma"; the int8 GEMM ran),
    |image - float image| on one noise with mode actions, three timed
    generations, peak memory and the quantized models' bytes."""
    _release_card()
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.kernels import quant as tq
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    unet, text, vae = _sd15_models(gen)
    policy = FactorNet(
        FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, family="sd"), device="cuda")
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=policy,
                               tokenizer=HashTokenizer(), device="cuda")
    ids = tokenize_batch(HashTokenizer(), PROMPTS[:BATCH], 77)
    noise = torch.randn((BATCH, 64, 64, 4), device="cuda", generator=gen)

    def generate(p, seed, **kw):
        images, _ = p(torch.Generator(device="cuda").manual_seed(seed), ids, noise,
                      num_inference_steps=STEPS, guidance_scale=CFG, record=False, **kw)
        return images

    float_images = generate(pipe, SEED + 161, deterministic_policy=True)
    out = {"phase": "int8_sd", "batch": BATCH, "steps": STEPS, "cfg": CFG, "resolution": 512,
           "float_unet_bytes": tq.module_bytes(unet), "float_vae_bytes": tq.module_bytes(vae)}
    for label, skip in QUANT_SKIP.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qpipe = pipe.quantize(skip)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        fa.reset_counts()
        tq.int_mm.launches = 0
        images = generate(qpipe, SEED + 162)
        torch.cuda.synchronize()
        launches, by_route = _counts(fa)
        int_mm = tq.int_mm.launches
        lo, hi = images.min().item(), images.max().item()
        det = generate(qpipe, SEED + 161, deterministic_policy=True)
        delta = (det - float_images).abs()
        generate(qpipe, SEED + 163)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_s = []
        for i in range(3):
            t0 = time.perf_counter()
            generate(qpipe, SEED + 164 + i)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
        out[label] = {
            "skip_levels": list(skip), "quantize_s": quantize_s,
            "launches": launches, "launches_by_route": by_route, "int_mm_per_generation": int_mm,
            "img_per_s": BATCH * len(run_s) / sum(run_s), "s_per_generation": sum(run_s) / 3,
            "run_s": run_s, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "unet_bytes": tq.module_bytes(qpipe.unet), "vae_bytes": tq.module_bytes(qpipe.vae),
            "image_min": lo, "image_max": hi,
            "delta_vs_float_mean": delta.mean().item(), "delta_vs_float_max": delta.max().item(),
        }
        print(json.dumps({"phase": f"int8_sd_{label}", **out[label]}), flush=True)
        if tuple(images.shape) != (BATCH, 512, 512, 3) or not bool(torch.isfinite(images).all()):
            raise AssertionError(f"int8 SD {label}: images {tuple(images.shape)}")
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"int8 SD {label}: images outside [0, 1]: {lo} {hi}")
        if launches != LAUNCHES_PER_GENERATION or by_route.get("mma") != LAUNCHES_PER_GENERATION:
            raise AssertionError(f"int8 SD {label}: flash_attention launched {launches} times "
                                 f"({by_route}), want {LAUNCHES_PER_GENERATION} on mma")
        if int_mm == 0:
            raise AssertionError(f"int8 SD {label}: the int8 GEMM never ran")
        del qpipe, images, det
        torch.cuda.empty_cache()
    del pipe, unet, text, vae, float_images
    torch.cuda.empty_cache()
    return out


def phase_int8_flux(fa):
    """FLUX-Kontext through ``FluxKontextPipeline.quantize(8)`` and
    ``quantize(4)``: a check edit (kernel #1 287 times, all "mma"; images
    finite in [0, 1]; |image - bf16 image| with mode actions), then one
    timed 1024^2 edit of 5 steps; the DiT's bytes, the time to quantize and
    the peak, with the bf16 pipeline resident throughout."""
    _release_card()
    import torch

    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.kernels import quant as tq
    from consolver_torch.pipelines.edit import FluxKontextPipeline

    gen = torch.Generator(device="cuda").manual_seed(SEED + 170)
    transformer, t5, clip, vae, policy = _flux_models("cuda", torch.bfloat16, False, gen, 0.02)
    pipe = FluxKontextPipeline(transformer, t5, clip, vae, factor_net=policy, device="cuda")
    prompt = ["make the sky a sunset orange"]
    t5_ids = tokenize_batch(HashTokenizer(vocab_size=32128, max_length=512), prompt, 512)
    clip_ids = tokenize_batch(HashTokenizer(), prompt, 77)
    ref_image = torch.rand((1, 1024, 1024, 3), device="cuda", generator=gen) * 2 - 1
    noise = torch.randn((1, 128, 128, 16), device="cuda", generator=gen)

    def edit(p, seed, **kw):
        images, _ = p(torch.Generator(device="cuda").manual_seed(seed), t5_ids, clip_ids,
                      ref_image, noise, num_inference_steps=FLUX_STEPS,
                      guidance_scale=FLUX_GUIDANCE, record=False, **kw)
        return images

    float_images = edit(pipe, SEED + 171, deterministic_policy=True)
    out = {"phase": "int8_flux", "resolution": 1024, "steps": FLUX_STEPS, "joint_tokens": 8704,
           "bf16_dit_bytes": tq.module_bytes(transformer)}
    for bits in (8, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        qpipe = pipe.quantize(bits)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        quantize_peak = torch.cuda.max_memory_allocated() / 2**30
        fa.reset_counts()
        tq.int_mm.launches = 0
        torch.cuda.reset_peak_memory_stats()
        images = edit(qpipe, SEED + 171, deterministic_policy=True)
        torch.cuda.synchronize()
        launches, by_route = _counts(fa)
        int_mm = tq.int_mm.launches
        lo, hi = images.min().item(), images.max().item()
        delta = (images - float_images).abs()
        t0 = time.perf_counter()
        edit(qpipe, SEED + 172)
        torch.cuda.synchronize()
        s_per_edit = time.perf_counter() - t0
        key = f"int{bits}"
        out[key] = {
            "quantize_s": quantize_s, "quantize_peak_gib": quantize_peak,
            "dit_bytes": tq.module_bytes(qpipe.transformer), "vae_bytes": tq.module_bytes(qpipe.vae),
            "launches": launches, "launches_by_route": by_route, "int_mm_per_edit": int_mm,
            "s_per_edit": s_per_edit, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "image_min": lo, "image_max": hi,
            "delta_vs_bf16_mean": delta.mean().item(), "delta_vs_bf16_max": delta.max().item(),
        }
        print(json.dumps({"phase": f"int8_flux_{key}", **out[key]}), flush=True)
        if tuple(images.shape) != (1, 1024, 1024, 3) or not bool(torch.isfinite(images).all()):
            raise AssertionError(f"FLUX {key}: images {tuple(images.shape)}")
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"FLUX {key}: images outside [0, 1]: {lo} {hi}")
        if launches != LAUNCHES_PER_EDIT or by_route.get("mma") != LAUNCHES_PER_EDIT:
            raise AssertionError(f"FLUX {key}: flash_attention launched {launches} times "
                                 f"({by_route}), want {LAUNCHES_PER_EDIT} on mma")
        if int_mm == 0:  # int4 keeps the VAE decoder int8
            raise AssertionError(f"FLUX {key}: the int8 GEMM never ran")
        del qpipe, images
        _release_card()
    del pipe, transformer, t5, clip, vae, policy, float_images
    _release_card()
    return out


def _quant_layers_in_place(cpu_model, card_model, run_cpu, tol):
    """Every quantized layer of ``card_model`` fed the input its CPU twin got
    in ``run_cpu()``: the CPU output within ``tol`` of its largest
    magnitude.  Returns (layers checked, worst error over that magnitude)."""
    import torch

    from consolver_torch.kernels import quant as tq

    calls = []
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: calls.append(
        (name, args[0], out))) for name, m in cpu_model.named_modules()
        if isinstance(m, tq.QUANTIZED_LAYERS)]
    try:
        cpu_out = run_cpu()
    finally:
        for h in hooks:
            h.remove()
    card_layers = dict(card_model.named_modules())
    worst = 0.0
    for name, x, want in calls:
        got = card_layers[name](x.cuda()).cpu()
        worst = max(worst, ((got - want).abs().max() / want.abs().max().clamp_min(1e-12)).item())
    if not calls or worst > tol:
        raise AssertionError(f"quantized layers card vs cpu: {len(calls)} layers, worst {worst}")
    return len(calls), worst, cpu_out


def phase_tiny_quant(fa):
    """The tiny quantized f32 stacks, TF32 off, quantized on the CPU and
    copied to the card: the SD UNet (hybrid and uniform), the VAE decoder
    and the FLUX DiT (int8 and int4).  Each quantized layer on the card,
    fed its CPU twin's input, gives the CPU output within 1e-6 of its
    largest magnitude (int4: 1e-5, an f32 GEMM); the whole card output
    differs from the CPU one by less than quantization moves the CPU output
    from the float model's (relative L2: one activation's rounding can flip
    on a last-bit difference of a float layer, a whole quantization step)."""
    import dataclasses

    import torch

    from consolver_torch.kernels import quant as tq
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 180)
    unet = _random_fill_(UNet2DCondition(UNetConfig.tiny(), device="cpu"), gen, 0.1)
    vae = _random_fill_(AutoencoderKL(VaeConfig.tiny(), device="cpu"), gen, 0.1)
    dit = _random_fill_(FluxTransformer(FluxConfig.tiny(), device="cpu"), gen, 0.1)
    x = torch.randn((2, 8, 8, 4), generator=gen)
    t = torch.tensor([10, 500])
    ctx = torch.randn((2, 77, 32), generator=gen)
    z = torch.randn((2, 8, 8, 4), generator=gen)
    fargs = (torch.randn((1, 8, 16), generator=gen), torch.randn((1, 4, 32), generator=gen),
             torch.randn((1, 24), generator=gen), torch.ones(1), torch.ones(1),
             torch.zeros((8, 3)), torch.zeros((4, 3)))
    cases = [
        ("unet_hybrid", unet, dataclasses.replace(unet.cfg, quant_int8=True, quant_skip_levels=(0,)),
         UNet2DCondition, lambda m, d: m(x.to(d), t.to(d), ctx.to(d)), 1e-6),
        ("unet_uniform", unet, dataclasses.replace(unet.cfg, quant_int8=True), UNet2DCondition,
         lambda m, d: m(x.to(d), t.to(d), ctx.to(d)), 1e-6),
        ("vae_decoder", vae, dataclasses.replace(vae.cfg, quant_int8=True), AutoencoderKL,
         lambda m, d: m.decode(z.to(d)), 1e-6),
        ("flux_int8", dit, dataclasses.replace(dit.cfg, quant_int8=True), FluxTransformer,
         lambda m, d: m(*(a.to(d) for a in fargs)), 1e-6),
        ("flux_int4", dit, dataclasses.replace(dit.cfg, quant_int4=True), FluxTransformer,
         lambda m, d: m(*(a.to(d) for a in fargs)), 1e-5),
    ]
    out = {"phase": "tiny_quant"}
    with torch.inference_mode():
        for name, model, qcfg, build, run, tol in cases:
            cpu_q = tq.quantize_like(build(qcfg, device="meta"), model)
            card_q = copy.deepcopy(cpu_q).to("cuda")
            layers, worst, cpu_out = _quant_layers_in_place(cpu_q, card_q, lambda: run(cpu_q, "cpu"),
                                                            tol)
            before = tq.int_mm.launches
            card_out = run(card_q, "cuda").cpu()
            float_out = run(model, "cpu")
            card_vs_cpu = ((card_out - cpu_out).norm() / cpu_out.norm()).item()
            quant_vs_float = ((cpu_out - float_out).norm() / float_out.norm()).item()
            out[name] = {"layers": layers, "layer_worst_err": worst, "layer_tol": tol,
                         "card_vs_cpu_rel": card_vs_cpu, "cpu_quant_vs_float_rel": quant_vs_float,
                         "int_mm_launches": tq.int_mm.launches - before}
            if not (card_vs_cpu < quant_vs_float and bool(torch.isfinite(card_out).all())):
                raise AssertionError(f"tiny {name}: card vs cpu {out[name]}")
            if name != "flux_int4" and out[name]["int_mm_launches"] == 0:
                raise AssertionError(f"tiny {name}: the card's int8 GEMM never ran")
    print(json.dumps(out), flush=True)
    return out


SERVE_BATCH_SIZES = (1, BATCH)
SERVE_FLUSH_MS = 250.0  # the window in which concurrent requests join one batch
SERVE_ROUNDS = 3
REFINE_STEPS = 40  # /v1/refine's default (multistep-dpm)
EDIT_REFINE_STEPS = 28  # /v1/edit/refine's default (Euler, guidance 2.5)
EDIT_REF_SHAPE = (768, 1024, 3)  # a landscape reference: a real crop to do


def _post(opener, url, payload, timeout=900):
    """(status, JSON body, seconds) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    t0 = time.perf_counter()
    try:
        with opener.open(req, timeout=timeout) as r:
            return r.status, json.load(r), time.perf_counter() - t0
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}"), time.perf_counter() - t0


def _image(body):
    import base64

    from consolver_torch.utils import png

    return png.decode_png(base64.b64decode(body["image_png_b64"]))


def _ok(code, body, what):
    if code != 200:
        raise AssertionError(f"{what}: HTTP {code} {body}")
    return body


def _check_image(img, side, what):
    import numpy as np

    if img.shape != (side, side, 3) or img.dtype != np.uint8:
        raise AssertionError(f"{what}: image {img.shape} {img.dtype}")


def _counts(fa):
    return fa.flash_attention.launches, dict(fa.flash_attention.launches_by_route)


def _check_launches(fa, want, what):
    launches, by_route = _counts(fa)
    if launches != want or by_route.get("mma") != want:
        raise AssertionError(f"{what}: flash_attention launched {launches} times ({by_route}), "
                             f"want {want} on mma")
    return launches, by_route


def _check_resizes(rz, what):
    """One reference resized, on the card: an edit's ``engine.prep``."""
    if rz.launches_by_route != {"card": 1, "host": 0}:
        raise AssertionError(f"{what}: the reference was resized {rz.launches_by_route}, "
                             "want once on the card")
    return dict(rz.launches_by_route)


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def phase_serve(fa, runs_by_path):
    """The serving path at full width through its HTTP server: one
    ``ServeServer`` on 127.0.0.1 carrying an SD-1.5 ``InferenceEngine``
    (batch shapes 1 and 8) and a FLUX-Kontext ``EditInferenceEngine`` (1024^2,
    batch 1, 128 T5 tokens).  Throughput of 8 concurrent generates (3
    rounds), the 9 zoo solvers with their kernel #1 launches, batch-slot
    independence, HTTP against direct pipeline calls, refine, the hot
    reload (and a 409 on other dims), a PreviewSession, and the edit,
    Euler edit and edit refine from a 1024x768 PNG."""
    import base64
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.edit_prep import center_crop_resize
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.kernels import resize as rz
    from consolver_torch.pipelines.edit import FluxKontextPipeline
    from consolver_torch.pipelines.preview import PreviewSession
    from consolver_torch.pipelines.solver_zoo import SOLVERS, make_solver
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.policy.io import save_factor_net
    from consolver_torch.serve import (EditInferenceEngine, EditRequest, GenerationRequest,
                                       InferenceEngine, make_server)
    from consolver_torch.serve.engine import _uint8_in_program, seed_noise
    from consolver_torch.utils import png

    _release_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140)
    t0 = time.perf_counter()
    unet, text, vae = _sd15_models(gen)
    policy_cfg = FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, family="sd")
    schedule = DiffusionSchedule.sd15()
    pipe = TextToImagePipeline(unet, text, vae, schedule, factor_net=FactorNet(policy_cfg, device="cuda"),
                               tokenizer=HashTokenizer(), device="cuda")
    sd = InferenceEngine(pipe, batch_size=BATCH, batch_sizes=SERVE_BATCH_SIZES, latent_size=64,
                         flush_ms=SERVE_FLUSH_MS)
    transformer, t5, clip, fvae, fpolicy = _flux_models("cuda", torch.bfloat16, False, gen, 0.02)
    edit_pipe = FluxKontextPipeline(transformer, t5, clip, fvae, factor_net=fpolicy, device="cuda")
    edit = EditInferenceEngine(edit_pipe, resolution=1024, batch_size=1,
                               t5_max_length=SERVE_T5_TOKENS)
    build_s = time.perf_counter() - t0
    resident_gib = torch.cuda.memory_allocated() / 2**30
    server = make_server(sd, host="127.0.0.1", port=0, edit_engine=edit)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy for localhost
    out = {"phase": "serve", "models_build_s": build_s, "baseline_gib": baseline_gib,
           "resident_gib": resident_gib}

    def post(path, payload):
        return _post(opener, base + path, payload)

    def gen_body(i, **kw):
        return {"prompt": PROMPTS[i % len(PROMPTS)], "seed": 1000 + i, "num_inference_steps": STEPS,
                "guidance_scale": CFG, **kw}

    def concurrent(bodies):
        barrier = threading.Barrier(len(bodies))

        def one(body):
            barrier.wait()
            return post("/v1/generate", body)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            results = list(pool.map(one, bodies))
        return results, time.perf_counter() - t0

    def stats_delta(before):
        after = sd.stats()
        return {k: after[k] - before[k] for k in ("batches", "batched_rows", "padded_rows")}

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:  # noqa: S310 - localhost
            if json.load(r) != {"ok": True}:
                raise AssertionError("healthz")
        # 1. prewarm every SD signature used below, at each batch shape
        t0 = time.perf_counter()
        warm = [GenerationRequest("warm", num_inference_steps=STEPS, guidance_scale=CFG),
                GenerationRequest("warm", num_inference_steps=STEPS, guidance_scale=CFG,
                                  deterministic=True),
                GenerationRequest("warm", num_inference_steps=REFINE_STEPS, guidance_scale=CFG,
                                  solver="multistep-dpm")]
        warm += [GenerationRequest("warm", num_inference_steps=STEPS, guidance_scale=CFG,
                                   solver=name) for name in SOLVERS]
        out["prewarmed"] = sd.prewarm(*warm, timeout=600)
        out["prewarm_s"] = time.perf_counter() - t0

        # 2. throughput: 8 concurrent requests per round, one batch of 8 each
        rounds, latencies = [], []
        fa.reset_counts()
        for r in range(SERVE_ROUNDS):
            before = sd.stats()
            results, wall = concurrent([gen_body(r * BATCH + i) for i in range(BATCH)])
            for code, body, sec in results:
                _check_image(_image(_ok(code, body, "generate")), 512, "generate")
                latencies.append(sec)
            delta = stats_delta(before)
            rounds.append({"wall_s": wall, **delta})
            if delta != {"batches": 1, "batched_rows": BATCH, "padded_rows": 0}:
                raise AssertionError(f"round {r} did not form one batch of {BATCH}: {delta}")
        torch.cuda.synchronize()
        serve_sd = dict(zip(("launches", "launches_by_route"),
                            _check_launches(fa, SERVE_ROUNDS * LAUNCHES_PER_GENERATION, "serve rounds")))
        stats = sd.stats()
        out["throughput"] = {
            "rounds": rounds, "img_per_s": SERVE_ROUNDS * BATCH / sum(x["wall_s"] for x in rounds),
            "pipeline_img_per_s": runs_by_path["sd"]["img_per_s"],
            "latency_p50_s": _percentile(latencies, 0.5), "latency_p95_s": _percentile(latencies, 0.95),
            "occupancy": stats["mean_batch_occupancy"],
            "engine_ms": {k: stats.get(k) for k in ("queue_wait_ms_p50", "execute_ms_p50",
                                                    "execute_ms_p95", "dispatch_ms_p50")},
        }
        print(json.dumps({"phase": "serve_throughput", **out["throughput"]}), flush=True)

        # dispatch / fetch overlap: two batches submitted back to back
        before = sd.stats()
        t0 = time.perf_counter()
        futs = [sd.submit(GenerationRequest(PROMPTS[i % BATCH], seed=1500 + i)) for i in range(2 * BATCH)]
        for f in futs:
            f.result(timeout=600)
        two_s = time.perf_counter() - t0
        with sd._lock:
            dispatch_ms, exec_ms = list(sd._dispatch_ms)[-2:], list(sd._exec_ms)[-2:]
        out["overlap"] = {"two_batches_s": two_s, "dispatch_ms": dispatch_ms, "execute_ms": exec_ms,
                          "one_batch_s": sum(x["wall_s"] for x in rounds) / SERVE_ROUNDS,
                          **stats_delta(before)}

        # 3. the zoo: one lone request per solver (batch shape 1)
        zoo, images = {}, {}
        for name in SOLVERS:
            entries = len(make_solver(name, schedule, STEPS, noise_fn=lambda i, shape: None).timesteps)
            want = UNET_LAUNCHES * entries + SD_VAE_LAUNCHES
            fa.reset_counts()
            code, body, sec = post("/v1/generate", gen_body(0, solver=name, seed=2000))
            images[name] = _image(_ok(code, body, name))
            _check_image(images[name], 512, name)
            torch.cuda.synchronize()
            _check_launches(fa, want, f"zoo {name}")
            zoo[name] = {"latency_s": sec, "model_calls": entries, "launches": want}
        for i, a in enumerate(SOLVERS):
            for b in SOLVERS[i + 1:]:
                if np.array_equal(images[a], images[b]):
                    raise AssertionError(f"zoo solvers {a} and {b} gave the same image")
        out["zoo"] = zoo
        serve_sd["zoo"] = {name: z["launches"] for name, z in zoo.items()}

        # 4. batch-slot independence: a deterministic request (pinned to
        # shape 8) alone, then at every slot of full batches of other
        # deterministic requests
        def det(i, seed):
            return GenerationRequest(PROMPTS[i % len(PROMPTS)], seed=seed, num_inference_steps=STEPS,
                                     guidance_scale=CFG, deterministic=True)

        out["slots"] = _slots_bit_equal(sd, det, "serve_slots")

        # 5. HTTP equals a direct call, 6. refine from the preview's seed
        def direct(prompt, seed, rows=1, pipeline=pipe, **kw):
            """The engine's first row, by TextToImagePipeline.__call__ on
            the engine's inputs for ``rows`` copies of one request."""
            ids = tokenize_batch(HashTokenizer(), [prompt] * rows, 77,
                                 vocab_size=pipeline.text_encoder.cfg.vocab_size)
            noise = seed_noise([seed] * rows, (64, 64, 4)).cuda()
            images, _ = pipeline(torch.Generator("cuda").manual_seed(seed), ids, noise,
                                 guidance_scale=CFG, record=False, **kw)
            return _uint8_in_program(images)[0].cpu().numpy()

        code, body, gen_s = post("/v1/generate", gen_body(5, seed=4000))
        http_gen = _image(_ok(code, body, "generate"))
        code, body, refine_s = post("/v1/refine", {"prompt": PROMPTS[5], "seed": 4000})
        http_refine = _image(_ok(code, body, "refine"))
        torch.cuda.synchronize()
        equal = {
            "generate": _max_diff(http_gen, direct(PROMPTS[5], 4000, num_inference_steps=STEPS)),
            "refine": _max_diff(http_refine, direct(PROMPTS[5], 4000, num_inference_steps=REFINE_STEPS,
                                                   solver="multistep-dpm")),
        }
        out["http_vs_direct_max_diff"] = equal
        out["refine"] = {"latency_s": refine_s, "steps": REFINE_STEPS, "generate_latency_s": gen_s}
        if max(equal.values()) != 0:
            raise AssertionError(f"HTTP images differ from direct calls: {equal}")

        # 7. hot reload of a differently seeded export; 409 on other dims
        hot = gen_body(6, seed=5000, deterministic=True)
        before_reload = _image(_ok(*post("/v1/generate", hot)[:2], "before reload"))
        new_net = _random_fill_(FactorNet(policy_cfg, device="cuda"),
                                torch.Generator(device="cuda").manual_seed(SEED + 141), 0.3)
        with tempfile.TemporaryDirectory() as tmp:
            save_factor_net(new_net, f"{tmp}/good")
            save_factor_net(FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=21),
                                      device="cuda"), f"{tmp}/bad")
            code, body, reload_s = post("/v1/admin/reload_factor",
                                        {"path": f"{tmp}/good", "engine": "generate"})
            _ok(code, body, "reload")
            bad_code = post("/v1/admin/reload_factor", {"path": f"{tmp}/bad", "engine": "generate"})[0]
        after_reload = _image(_ok(*post("/v1/generate", hot)[:2], "after reload"))
        new_pipe = TextToImagePipeline(unet, text, vae, schedule, factor_net=new_net,
                                       tokenizer=HashTokenizer(), device="cuda")
        want_after = direct(PROMPTS[6], 5000, rows=BATCH, pipeline=new_pipe, num_inference_steps=STEPS,
                            deterministic_policy=True)
        out["hot_reload"] = {"reload_s": reload_s, "changed": not np.array_equal(before_reload, after_reload),
                             "max_diff_vs_direct_new_net": _max_diff(after_reload, want_after),
                             "other_dims_status": bad_code}
        if not out["hot_reload"]["changed"]:
            raise AssertionError("the reloaded policy did not change a deterministic request")
        if not np.array_equal(after_reload, want_after):
            raise AssertionError(f"after the reload: {out['hot_reload']} (stale denoise cache?)")
        if bad_code != 409:
            raise AssertionError(f"an export with other dims returned {bad_code}, want 409")

        # 8. PreviewSession at full width: 4 candidates, then refine one
        session = PreviewSession(pipe)
        fa.reset_counts()
        t0 = time.perf_counter()
        previews = session.preview(torch.Generator("cuda").manual_seed(6000),
                                   tokenize_batch(HashTokenizer(), [PROMPTS[7]], 77,
                                                  vocab_size=text.cfg.vocab_size)[0],
                                   num_candidates=4)
        torch.cuda.synchronize()
        preview_s = time.perf_counter() - t0
        _check_launches(fa, LAUNCHES_PER_GENERATION, "preview session")
        fa.reset_counts()
        t0 = time.perf_counter()
        refined = session.refine(previews[1])
        torch.cuda.synchronize()
        session_refine_s = time.perf_counter() - t0
        _check_launches(fa, UNET_LAUNCHES * REFINE_STEPS + SD_VAE_LAUNCHES, "session refine")
        for img in [p.image for p in previews] + [refined]:
            if tuple(img.shape) != (512, 512, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"preview session image {tuple(img.shape)}")
        out["preview_session"] = {"candidates": 4, "preview_s": preview_s, "refine_s": session_refine_s}

        # the host's PNG work per 512^2 image, at the server's zlib level 1 and at 6
        for level in (1, 6):
            t0 = time.perf_counter()
            for _ in range(5):
                size = len(png.encode_png(http_gen, level=level))
            out[f"png_encode_512_level{level}"] = {"ms": (time.perf_counter() - t0) / 5 * 1e3,
                                                   "bytes": size}
        print(json.dumps({"phase": "serve_sd", **{k: v for k, v in out.items() if k != "throughput"}}),
              flush=True)

        # edits from a 1024x768 reference PNG
        ref = np.random.default_rng(SEED + 142).integers(0, 256, EDIT_REF_SHAPE, np.uint8)
        t0 = time.perf_counter()
        ref_png = png.encode_png(ref, level=1)
        host = {"png_encode_ref_ms": (time.perf_counter() - t0) * 1e3}
        t0 = time.perf_counter()
        png.decode_png(ref_png)
        host["png_decode_ref_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        center_crop_resize(ref, 1024)
        host["center_crop_resize_ms"] = (time.perf_counter() - t0) * 1e3
        ref_b64 = base64.b64encode(ref_png).decode()
        instruction = "make the sky a sunset orange"

        def edit_body(**kw):
            return {"instruction": instruction, "image_png_b64": ref_b64, "seed": 7000, **kw}

        t0 = time.perf_counter()
        edit.prewarm(EditRequest(instruction, ref, num_inference_steps=FLUX_STEPS,
                                 guidance_scale=FLUX_GUIDANCE), timeout=900)
        edit_prewarm_s = time.perf_counter() - t0
        edits = {}
        for name, path, body, steps in (
                ("edit", "/v1/edit", edit_body(num_inference_steps=FLUX_STEPS), FLUX_STEPS),
                ("edit_euler", "/v1/edit", edit_body(num_inference_steps=FLUX_STEPS, solver="euler"),
                 FLUX_STEPS),
                ("edit_refine", "/v1/edit/refine", edit_body(), EDIT_REFINE_STEPS)):
            fa.reset_counts()
            rz.reset_counts()
            code, resp, sec = post(path, body)
            img = _image(_ok(code, resp, name))
            _check_image(img, 1024, name)
            torch.cuda.synchronize()
            launches = _check_launches(fa, DIT_LAUNCHES * steps + 2 * FLUX_VAE_LAUNCHES, name)
            resizes = _check_resizes(rz, name)
            edits[name] = {"latency_s": sec, "steps": steps, "launches": launches[0],
                           "resize_launches_by_route": resizes}
            if name == "edit":
                serve_edit = {**dict(zip(("launches", "launches_by_route"), launches)),
                              "resize_launches_by_route": resizes}
        det = []
        for _ in range(2):
            rz.reset_counts()
            det.append(_image(_ok(*post("/v1/edit", edit_body(
                seed=7001, deterministic=True, num_inference_steps=FLUX_STEPS))[:2],
                "deterministic edit")))
            _check_resizes(rz, "deterministic edit")
        if not np.array_equal(*det):
            raise AssertionError("a deterministic edit served twice differs")
        out_edit = {
            "phase": "serve_edit", "resolution": 1024, "t5_tokens": SERVE_T5_TOKENS,
            "joint_tokens": 8192 + SERVE_T5_TOKENS, "ref_shape": list(EDIT_REF_SHAPE),
            "prewarm_s": edit_prewarm_s, "edits": edits,
            "s_per_edit_http": edits["edit"]["latency_s"],
            "pipeline_s_per_edit": runs_by_path["flux"]["s_per_edit"],
            "deterministic_bit_equal": True, **host,
            "edit_stats": {k: edit.stats().get(k) for k in ("completed", "execute_ms_p50",
                                                           "dispatch_ms_p50", "queue_wait_ms_p50")},
        }
        out["edit"] = out_edit
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out_edit["peak_mem_gib"] = out["peak_mem_gib"]
        print(json.dumps(out_edit), flush=True)
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:  # noqa: S310 - localhost
            final_stats = json.load(r)
        if set(final_stats) != {"generate", "edit"} or final_stats["generate"]["errors"]:
            raise AssertionError(f"server stats: {final_stats}")
        out["int8"] = phase_serve_int8(fa, pipe, edit_pipe, policy_cfg, edit_body)
    finally:
        server.shutdown()
        server.server_close()
        sd.shutdown()
        edit.shutdown()
    out["serve_sd"], out["serve_edit"] = serve_sd, serve_edit
    del sd, edit, pipe, edit_pipe, unet, text, vae, transformer, t5, clip, fvae, fpolicy
    torch.cuda.empty_cache()
    return out


def _max_diff(a, b):
    import numpy as np

    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _slots_bit_equal(engine, make_request, label):
    """A deterministic request served alone (padded to the pinned batch
    shape), then at every slot of full batches of other deterministic
    requests (``engine.submit`` in order: the arrival order is the slot):
    bit-equal at every slot."""
    target = make_request(3, 3000)
    before = engine.stats()
    solo = engine.generate(target, timeout=600)
    diffs, shares, batch_s = [], [], []
    for slot in range(BATCH):
        others = [make_request(10 + i, 3100 + 10 * slot + i) for i in range(BATCH - 1)]
        t0 = time.perf_counter()
        futs = [engine.submit(r) for r in others[:slot] + [target] + others[slot:]]
        img = [f.result(timeout=600) for f in futs][slot]
        batch_s.append(time.perf_counter() - t0)
        diffs.append(_max_diff(solo, img))
        shares.append(float((solo != img).mean()))
    after = engine.stats()
    delta = {k: after[k] - before[k] for k in ("batches", "batched_rows", "padded_rows")}
    result = {"max_diff_by_slot": diffs, "share_differing_by_slot": shares, "batch_s": batch_s,
              **delta}
    print(json.dumps({"phase": label, **result}), flush=True)
    if delta != {"batches": 1 + BATCH, "batched_rows": 1 + BATCH * BATCH, "padded_rows": BATCH - 1}:
        raise AssertionError(f"{label}: deterministic solo + {BATCH} full batches: {delta}")
    if any(diffs):
        raise AssertionError(f"{label}: a deterministic request is not bit-equal at every slot: "
                             f"{result}")
    return result


def phase_serve_int8(fa, pipe, edit_pipe, policy_cfg, edit_body):
    """The int8 engines behind their own ``ServeServer``: an SD-1.5
    ``InferenceEngine`` over ``pipe.quantize()`` (the hybrid) and a
    FLUX-Kontext ``EditInferenceEngine`` over ``edit_pipe.quantize(8)``,
    beside the float engines.  Two rounds of 8 concurrent ``/v1/generate``
    (one batch each; served img/s, p50), a deterministic request bit-equal
    at every slot, a hot reload (the image changes and equals the new net's
    direct call), and one ``/v1/edit``."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.kernels import quant as tq
    from consolver_torch.kernels import resize as rz
    from consolver_torch.policy.factor_net import FactorNet
    from consolver_torch.serve import EditInferenceEngine, GenerationRequest, InferenceEngine, make_server
    from consolver_torch.serve.engine import _uint8_in_program, seed_noise

    t0 = time.perf_counter()
    qpipe = pipe.quantize()
    qedit_pipe = edit_pipe.quantize(8)
    torch.cuda.synchronize()
    out = {"phase": "serve_int8", "quantize_s": time.perf_counter() - t0,
           "resident_gib": torch.cuda.memory_allocated() / 2**30}
    sd = InferenceEngine(qpipe, batch_size=BATCH, batch_sizes=SERVE_BATCH_SIZES, latent_size=64,
                         flush_ms=SERVE_FLUSH_MS)
    edit = EditInferenceEngine(qedit_pipe, resolution=1024, batch_size=1,
                               t5_max_length=SERVE_T5_TOKENS)
    server = make_server(sd, host="127.0.0.1", port=0, edit_engine=edit)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy for localhost

    def post(path, payload):
        return _post(opener, base + path, payload)

    def det(i, seed):
        return GenerationRequest(PROMPTS[i % len(PROMPTS)], seed=seed, num_inference_steps=STEPS,
                                 guidance_scale=CFG, deterministic=True)

    try:
        out["prewarmed"] = sd.prewarm(
            GenerationRequest("warm", num_inference_steps=STEPS, guidance_scale=CFG),
            det(0, 0), timeout=600)
        rounds, latencies = [], []
        fa.reset_counts()
        tq.int_mm.launches = 0
        for r in range(2):
            before = sd.stats()
            bodies = [{"prompt": PROMPTS[i], "seed": 8000 + r * BATCH + i,
                       "num_inference_steps": STEPS, "guidance_scale": CFG} for i in range(BATCH)]
            barrier = threading.Barrier(BATCH)

            def one(body):
                barrier.wait()
                return post("/v1/generate", body)

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=BATCH) as pool:
                results = list(pool.map(one, bodies))
            wall = time.perf_counter() - t0
            for code, body, sec in results:
                _check_image(_image(_ok(code, body, "int8 generate")), 512, "int8 generate")
                latencies.append(sec)
            after = sd.stats()
            delta = {k: after[k] - before[k] for k in ("batches", "batched_rows", "padded_rows")}
            rounds.append({"wall_s": wall, **delta})
            if delta != {"batches": 1, "batched_rows": BATCH, "padded_rows": 0}:
                raise AssertionError(f"int8 round {r} did not form one batch of {BATCH}: {delta}")
        torch.cuda.synchronize()
        launches = _check_launches(fa, 2 * LAUNCHES_PER_GENERATION, "int8 serve rounds")
        out["throughput"] = {
            "rounds": rounds, "img_per_s": 2 * BATCH / sum(x["wall_s"] for x in rounds),
            "latency_p50_s": _percentile(latencies, 0.5),
            "latency_p95_s": _percentile(latencies, 0.95),
            "launches": launches[0], "int_mm_launches": tq.int_mm.launches,
        }
        if tq.int_mm.launches == 0:
            raise AssertionError("int8 serving: the int8 GEMM never ran")
        out["slots"] = _slots_bit_equal(sd, det, "serve_int8_slots")

        # hot reload on the quantized engine
        before_img = sd.generate(det(6, 5000), timeout=600)
        new_net = _random_fill_(FactorNet(policy_cfg, device="cuda"),
                                torch.Generator(device="cuda").manual_seed(SEED + 143), 0.3)
        sd.update_factor_params(new_net.state_dict())
        after_img = sd.generate(det(6, 5000), timeout=600)
        direct_pipe = sd.pipeline
        ids = tokenize_batch(HashTokenizer(), [PROMPTS[6]] * BATCH, 77,
                             vocab_size=direct_pipe.text_encoder.cfg.vocab_size)
        noise = seed_noise([5000] * BATCH, (64, 64, 4)).cuda()
        images, _ = direct_pipe(torch.Generator("cuda").manual_seed(5000), ids, noise,
                                num_inference_steps=STEPS, guidance_scale=CFG, record=False,
                                deterministic_policy=True)
        want = _uint8_in_program(images)[0].cpu().numpy()
        out["hot_reload"] = {"changed": not np.array_equal(before_img, after_img),
                             "max_diff_vs_direct_new_net": _max_diff(after_img, want),
                             "int8_unet_kept": direct_pipe.unet is qpipe.unet}
        if not (out["hot_reload"]["changed"] and out["hot_reload"]["int8_unet_kept"]
                and np.array_equal(after_img, want)):
            raise AssertionError(f"int8 hot reload: {out['hot_reload']}")

        # one edit through the int8 edit engine
        fa.reset_counts()
        rz.reset_counts()
        tq.int_mm.launches = 0
        code, resp, sec = post("/v1/edit", edit_body(num_inference_steps=FLUX_STEPS))
        img = _image(_ok(code, resp, "int8 edit"))
        _check_image(img, 1024, "int8 edit")
        torch.cuda.synchronize()
        launches = _check_launches(fa, DIT_LAUNCHES * FLUX_STEPS + 2 * FLUX_VAE_LAUNCHES,
                                   "int8 edit")
        out["edit"] = {"latency_s": sec, "launches": launches[0],
                       "int_mm_launches": tq.int_mm.launches,
                       "resize_launches_by_route": _check_resizes(rz, "int8 edit")}
        if tq.int_mm.launches == 0:
            raise AssertionError("int8 edit: the int8 GEMM never ran")
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(json.dumps({k: v for k, v in out.items() if k != "slots"}), flush=True)
    finally:
        server.shutdown()
        server.server_close()
        sd.shutdown()
        edit.shutdown()
    del sd, edit, qpipe, qedit_pipe
    torch.cuda.empty_cache()
    return out

# phase_dist: data and tensor parallelism over two ranks.  On one card both
# ranks share cuda:0 over gloo (NCCL refuses two ranks on a device); with two
# or more cards each rank takes its own over NCCL.
DIST_RANKS = 2
DIST_SD_PPO_ROWS = 2 * SD_PPO_BATCH  # 80 per data rank, in 2 groups
DIST_SD_PPO_N = 6  # the step range pinned to one count
DIST_SERVE_BATCHES = 2  # one to warm, one timed
DIST_TIMEOUT_S = 900
# (a) the data-parallel update against the one-process update of the same
# gathered PPO batch (the same rows, rewards and advantages) from the same
# start: the summed gradient the optimizer is handed, as the largest
# difference over the largest entry, and the pre-clip gradient norm, within
# one bf16 ulp (2^-8), over the 160 x (n - 1) PPO rows.  The policy runs in
# f32, so the two differ only in the order of the row sum (about 1e-6); a
# row share left out, or a missing all_reduce, moves them by a half or more
# (checked on the CPU at a tiny size).  Then the data-parallel step against
# the one-process step at num_groups = 2 on the same 160 rows, in bf16: the
# policy's draws are the same global draws, so the actions agree except
# where a probability's last bf16 bits move an argmax (share of (row, step)
# pairs), and the mean reward agrees within DIST_REWARD_RTOL.
DIST_GRAD_RTOL = 2.0 ** -8
DIST_ACTIONS_AGREE = 0.99
DIST_REWARD_RTOL = 1e-2
# (b) the TP-2 DiT against the unsharded DiT (phase_flux) on one forward, as
# a share of the output's largest value (each rank rounds its bf16 partial
# products before the sum; measured 2.1 % on the H100 before this limit was
# set), and the TP-2 edit against the unsharded edit, in uint8 levels
# (measured 1).
DIST_DIT_LIMIT = 5e-2
DIST_EDIT_MAX_LEVELS = 2
# (c) the data-parallel engine is bit-equal to the unsharded engine serving
# one rank's batch shape (4), the same program, and to the unsharded batch-8
# engine: a deterministic program runs every batch-size-dependent route one
# sample at a time (``python -m consolver_torch.probes.dp_shapes``).


def _depth_model(seed):
    """Depth-Anything-V2-S in bf16, PyTorch's default init from ``seed``, its
    last conv made non-negative (``_backbone_models``)."""
    import torch

    from consolver_torch.models.depth_anything import DepthAnything, DepthAnythingConfig

    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(seed)
        model = DepthAnything(DepthAnythingConfig.small_v2(), device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p in model.head.conv3.parameters():
            p.abs_()
    return model


def _sd_serving_policy(seed):
    import torch

    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(seed)
        return FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11,
                                         family="sd"), device="cuda")


def _dist_sd_ppo(rank, p, fa, mesh):
    """(a) One SD-1.5 PPO step over the data ranks, the rank-0 checkpoint
    and every rank's resume; on rank 0 the one-process update of the same
    gathered PPO batch (rows, rewards, advantages) from the same start, and
    the one-process step on the same 160 rows at num_groups = 2."""
    import dataclasses
    import os

    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer
    from consolver_torch.dist import mesh as meshlib
    from consolver_torch.models.depth_anything import make_depth_fn
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.rewards.registry import RewardModel, make_reward_fn
    from consolver_torch.rl import ppo
    from consolver_torch.rl.train import PPOTrainer, TrainConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    unet, text, vae = _sd15_models(gen)
    depth = make_reward_fn("depth", RewardModel(depth=make_depth_fn(_depth_model(SEED + 81))))
    policy_cfg = FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, hidden_dim=256,
                                 family="sd")

    def pipeline(state=None):
        net = FactorNet(policy_cfg, device="cuda")
        if state is not None:
            net.load_state_dict(state)
        return TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=net,
                                   tokenizer=HashTokenizer(), device="cuda")

    config = TrainConfig(
        max_train_steps=1, guidance_scale=CFG, min_inference_steps=DIST_SD_PPO_N,
        max_inference_steps=DIST_SD_PPO_N + 1, seed=PPO_SEED,
        output_dir=os.path.join(p["tmp"], "dp_run"), checkpointing_steps=1,
        decode_chunk=SD_PPO_DECODE_CHUNK,
        ppo=ppo.PPOConfig(ppo_epochs=SD_PPO_EPOCHS, learning_rate=SD_PPO_LR,
                          weight_decay=SD_PPO_WD, advantage_scale=SD_PPO_ADV_SCALE))
    captured = []  # (actions, flat PPO batch) of each train_step
    flatten = ppo.flatten_trajectory

    def record(traj, advantages):
        flat = flatten(traj, advantages)
        captured.append((traj.actions, flat))
        return flat

    ppo.flatten_trajectory = record
    pipe = pipeline()
    trainer = PPOTrainer(pipe, depth, config, mesh=mesh)
    start = {k: v.clone() for k, v in pipe.factor_net.state_dict().items()}  # rank 0's, broadcast
    dp_grads = []  # the summed gradient the optimizer is handed, before its clip
    optimizer_step = trainer.optimizer.step

    def record_grads():
        dp_grads.append([q.grad.detach().clone() for q in trainer.optimizer.params])
        optimizer_step()

    trainer.optimizer.step = record_grads
    fa.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = trainer.train_step(p["sd_batch"])
    torch.cuda.synchronize()
    out = {"s_step": time.perf_counter() - t0, "metrics": metrics,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "grad_all_reduce_ms": trainer.grad_sync.last_ms,
           "launches": fa.flash_attention.launches,
           "launches_by_route": dict(fa.flash_attention.launches_by_route),
           "launches_want": sd_ppo_launches(DIST_SD_PPO_N, reward=BACKBONE_LAUNCHES["depth"]),
           "num_groups": trainer.num_groups}
    out["param_sum"] = trainer.param_sum()  # raises when the ranks differ
    out["params_finite"] = all(bool(q.isfinite().all()) for q in trainer.factor_net.parameters())
    trainer.save_checkpoint()  # rank 0 writes, every rank waits
    out["checkpoints"] = sorted(os.listdir(config.output_dir))
    resumed = PPOTrainer(pipeline(), depth, config, mesh=mesh)
    out["resumed"] = resumed.resume_from_checkpoint("latest")
    out["resume_bit_equal"] = _bit_equal(_trainer_state(resumed), _trainer_state(trainer))
    dp_actions, dp_flat = captured[0]
    actions = mesh.all_gather(dp_actions.contiguous(), "data")
    conds, *rest = meshlib.gather_batch(mesh, list(dp_flat))  # the global PPO batch
    del resumed
    torch.cuda.empty_cache()
    if rank == 0:
        net = FactorNet(policy_cfg, device="cuda")
        net.load_state_dict(start)
        optimizer = ppo.make_optimizer(net, config.ppo)
        one_grads = []
        optimizer.step = lambda: one_grads.append([q.grad.detach() for q in optimizer.params])
        aux = ppo.make_update_fn(net, optimizer, config.ppo)(conds, *rest)
        scale = max(float(g.abs().max()) for g in one_grads[0])
        out["grad_check"] = {
            "max_rel_err": max(float((a - b).abs().max()) for a, b in zip(
                dp_grads[0], one_grads[0], strict=True)) / scale,
            "grad_norm": [metrics["grad_norm"], float(aux["grad_norm"])],
            "loss": [metrics["loss"], float(aux["loss"])], "rows": int(rest[0].shape[0])}
        del net, optimizer, one_grads
        single = PPOTrainer(pipeline(start), depth,
                            dataclasses.replace(config, num_groups=2,
                                                output_dir=os.path.join(p["tmp"], "single")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single_metrics = single.train_step(p["sd_batch"])
        torch.cuda.synchronize()
        out["single"] = {"s_step": time.perf_counter() - t0, "metrics": single_metrics}
        single_actions = captured[-1][0]
        out["actions_agree"] = float((single_actions == actions).all(dim=-1).float().mean())
        out["reward_rel_diff"] = abs(metrics["reward"] - single_metrics["reward"]) / abs(
            single_metrics["reward"])
        del single
    ppo.flatten_trajectory = flatten
    mesh.barrier()
    del trainer, pipe, unet, text, vae, depth, conds, rest, dp_flat, captured
    return out


def _fill_sharded_(model, gen, mesh, rules, device="cuda"):
    """Materialise a ``meta`` model on ``device`` one unit at a time (each
    block of a ModuleList, each other child), filling its parameters from
    ``gen`` in the model's parameter order, and split each block by
    ``rules`` before the next is made: the full model never exists on the
    card.  Returns the split report."""
    import torch

    from consolver_torch.dist.tp import shard_module_by_rules

    report = {}
    for name, child in model.named_children():
        units = ([(f"{name}.{i}.", c) for i, c in enumerate(child)]
                 if isinstance(child, torch.nn.ModuleList) else [(None, child)])
        for prefix, unit in units:
            unit.to_empty(device=device)
            _random_fill_(unit, gen)
            if prefix is not None:
                for kind, paths in shard_module_by_rules(mesh, unit, rules, prefix).items():
                    report.setdefault(kind, []).extend(paths)
    for kind, paths in shard_module_by_rules(mesh, model, rules).items():
        report.setdefault(kind, []).extend(paths)
    return report


def _dist_flux_tp(rank, p, fa, mesh):
    """(b) The FLUX-Kontext DiT split over two model ranks: one forward held
    against phase_flux's unsharded forward, with the TP collectives counted
    and timed, then one deterministic 1024^2 edit through
    ``EditInferenceEngine(mesh=)`` held against phase_flux's."""
    import numpy as np
    import torch

    from consolver_torch.dist import tp
    from consolver_torch.kernels.quant import module_bytes
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.edit import FluxKontextPipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.serve import EditInferenceEngine

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)  # phase_flux's weights
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    transformer = FluxTransformer(FluxConfig.flux_kontext(), device="meta", dtype=bf16)
    report = _fill_sharded_(transformer, gen, mesh, tp.FLUX_TP_RULES)
    others = [T5Encoder(T5Config.xxl(), device="meta", dtype=bf16),
              ClipTextEncoder(ClipTextConfig.sd15(), device="meta", dtype=bf16),
              AutoencoderKL(VaeConfig(latent_channels=16, scaling_factor=0.3611), device="meta",
                            dtype=bf16)]
    for m in others:
        _random_fill_(m.to_empty(device="cuda"), gen)
    policy = FactorNet(FactorNetConfig(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11,
                                       hidden_dim=256, family="fm"), device="cuda")
    policy.load_state_dict(p["flux_ref"]["policy"])
    pipe = FluxKontextPipeline(transformer, *others, factor_net=policy, device="cuda")
    out = {"build_s": time.perf_counter() - t0, "dit_bytes": module_bytes(transformer),
           "t5_bytes": module_bytes(others[0]),
           "split": {k: len(v) for k, v in report.items()}}
    fa.reset_counts()
    tp.stats.reset()
    tp.stats.timing = True
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dit = transformer(*_dit_probe_inputs()).float().cpu()
        torch.cuda.synchronize()
    tp.stats.timing = False
    ref = p["flux_ref"]["dit_out"]
    out["forward"] = {"s": time.perf_counter() - t0, "collectives": dict(tp.stats.counts),
                      "collective_ms": dict(tp.stats.ms),
                      "max_abs_diff": float((dit - ref).abs().max()),
                      "mean_abs_diff": float((dit - ref).abs().mean()),
                      "ref_max_abs": float(ref.abs().max()),
                      "finite": bool(torch.isfinite(dit).all()),
                      "launches": fa.flash_attention.launches}
    fa.reset_counts()
    engine = EditInferenceEngine(pipe, resolution=1024, batch_size=1,
                                 t5_max_length=DIST_T5_TOKENS, mesh=mesh)
    if rank == 0:
        t0 = time.perf_counter()
        image = engine.generate(_dist_edit_request(), timeout=600)
        out["s_edit"] = time.perf_counter() - t0
        diff = np.abs(image.astype(np.int32) - p["flux_ref"]["edit"].astype(np.int32))
        out["edit_max_diff"], out["edit_mean_diff"] = int(diff.max()), float(diff.mean())
        out["edit_shape"] = list(image.shape)
    engine.shutdown()
    out["edit_launches"] = fa.flash_attention.launches
    out["edit_launches_by_route"] = dict(fa.flash_attention.launches_by_route)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del engine, pipe, transformer, others, policy
    return out


def _dist_gen_request(i):
    from consolver_torch.serve import GenerationRequest

    return GenerationRequest(prompt=PROMPTS[i % len(PROMPTS)], seed=3000 + i,
                             num_inference_steps=STEPS, guidance_scale=CFG, deterministic=True)


def _dist_serve(rank, p, fa, mesh):
    """(c) The SD-1.5 engine over the data ranks: two batches of 8
    deterministic requests (4 per rank), the second timed, held against the
    unsharded engines' images (phase_dist's parent)."""
    import numpy as np
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.serve import InferenceEngine

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    unet, text, vae = _sd15_models(gen)
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(),
                               factor_net=_sd_serving_policy(SEED + 91),
                               tokenizer=HashTokenizer(), device="cuda")
    fa.reset_counts()
    engine = InferenceEngine(pipe, batch_size=BATCH, latent_size=64, flush_ms=SERVE_FLUSH_MS,
                             mesh=mesh)
    out = {}
    if rank == 0:
        times, images = [], []
        for _ in range(DIST_SERVE_BATCHES):
            t0 = time.perf_counter()
            futs = [engine.submit(_dist_gen_request(i)) for i in range(BATCH)]
            images = [f.result(timeout=600) for f in futs]
            times.append(time.perf_counter() - t0)
        out["s_batch"] = times
        out["img_per_s"] = BATCH / times[-1]
        out["batches"] = engine.stats()["batches"]
        for size in (BATCH, BATCH // DIST_RANKS):
            ref = p["serve_ref"][size]
            out[f"equal_batch{size}"] = all(np.array_equal(a, b) for a, b in zip(images, ref))
            out[f"max_diff_batch{size}"] = max(
                int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
                for a, b in zip(images, ref))
    engine.shutdown()
    out["launches"] = fa.flash_attention.launches
    out["launches_by_route"] = dict(fa.flash_attention.launches_by_route)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del engine, pipe, unet, text, vae
    return out


def _dist_rank(rank, payload):
    """One rank of phase_dist: (a), (b) and (c) in turn, the card released
    between them."""
    import pickle

    import torch

    from consolver_torch.dist import mesh as meshlib
    from consolver_torch.kernels import flash_attention as fa

    p = pickle.loads(payload)
    # the parent's math settings: its references ran under them (the
    # models' f32 convolutions and products differ with TF32 on)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = p["tf32"]
    fa.build()
    dp = meshlib.init_mesh(DIST_RANKS)
    tp2 = meshlib.init_mesh(1, DIST_RANKS)
    out = {"rank": rank, "backend": dp.backend, "device": str(dp.device)}
    out["sd_ppo"] = _dist_sd_ppo(rank, p, fa, dp)
    _release_card()
    out["flux_tp"] = _dist_flux_tp(rank, p, fa, tp2)
    _release_card()
    out["serve"] = _dist_serve(rank, p, fa, dp)
    torch.cuda.synchronize()
    return out


def _dist_nccl_rank(rank):
    """(d) A world-1 NCCL group on the card: all_reduce, all_gather and
    broadcast of CUDA tensors through the mesh's collectives."""
    import torch

    from consolver_torch.dist import mesh as meshlib

    mesh = meshlib.init_mesh(1, device="cuda")
    x = torch.arange(4.0, device="cuda")
    reduced = mesh.all_reduce(x.clone()).tolist()
    gathered = mesh.all_gather(x, "world").tolist()
    sent = mesh.broadcast(x + 1).tolist()
    return {"backend": mesh.backend, "device": str(mesh.device), "world": mesh.world,
            "ok": reduced == x.tolist() and gathered == x.tolist() and sent == (x + 1).tolist()}


def phase_dist(fa, flux_ref):
    """Data and tensor parallelism on the card: (d) a world-1 NCCL group,
    then two ranks (gloo sharing cuda:0 on one card; NCCL, a card each, on
    two or more) run (a) SD-1.5 PPO over 2 data ranks (80 rows each, 2
    groups, ``sd15_ppo()``, depth, n = 6) against the one-process step,
    (b) the FLUX-Kontext DiT split over 2 model ranks, a forward and an
    edit through ``EditInferenceEngine(mesh=)`` against phase_flux's, (c)
    the SD-1.5 engine over 2 data ranks against the unsharded engines."""
    _release_card()
    import pickle
    import tempfile

    import numpy as np
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer
    from consolver_torch.dist import launch
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.serve import InferenceEngine

    # (c)'s references: the unsharded engine at batch 8 and at batch 4 (one
    # data rank's program), on the same models and requests
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    unet, text, vae = _sd15_models(gen)
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(),
                               factor_net=_sd_serving_policy(SEED + 91),
                               tokenizer=HashTokenizer(), device="cuda")
    serve_ref = {}
    for size in (BATCH, BATCH // DIST_RANKS):
        with InferenceEngine(pipe, batch_size=size, latent_size=64,
                             flush_ms=SERVE_FLUSH_MS) as engine:
            futs = [engine.submit(_dist_gen_request(i)) for i in range(BATCH)]
            serve_ref[size] = [f.result(timeout=600) for f in futs]
    del engine, pipe, unet, text, vae
    _release_card()
    rng = np.random.default_rng(PPO_SEED)
    sd_batch = {"noise": rng.standard_normal((DIST_SD_PPO_ROWS, 64, 64, 4)).astype(np.float32),
                "latent": rng.standard_normal((DIST_SD_PPO_ROWS, 64, 64, 4)).astype(np.float32),
                "prompt_ids": rng.integers(1, 49407, (DIST_SD_PPO_ROWS, 77)).astype(np.int64)}
    backend = "nccl" if torch.cuda.device_count() >= DIST_RANKS else "gloo"
    t0 = time.perf_counter()
    nccl = launch.spawn(_dist_nccl_rank, 1, backend="nccl", timeout_s=300)[0]
    nccl["s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        payload = pickle.dumps({"tmp": tmp, "sd_batch": sd_batch, "flux_ref": flux_ref,
                                "serve_ref": serve_ref, "tf32": tf32})
        t0 = time.perf_counter()
        ranks = launch.spawn(_dist_rank, DIST_RANKS, backend=backend, timeout_s=DIST_TIMEOUT_S,
                             args=(payload,))
        wall_s = time.perf_counter() - t0
    result = {"phase": "dist", "ranks": DIST_RANKS, "backend": ranks[0]["backend"],
              "devices": [r["device"] for r in ranks], "card_count": torch.cuda.device_count(),
              "nccl_world1": nccl, "wall_s": wall_s,
              **{part: [r[part] for r in ranks] for part in ("sd_ppo", "flux_tp", "serve")}}
    print(json.dumps(result, default=str), flush=True)
    _check_dist(result, backend)
    return result


def _check_dist(result, backend):
    nccl = result["nccl_world1"]
    if not (nccl["ok"] and nccl["backend"] == "nccl"):
        raise AssertionError(f"the world-1 NCCL collectives failed: {nccl}")
    if result["backend"] != backend:
        raise AssertionError(f"the ranks ran {result['backend']}, want {backend}")
    a = result["sd_ppo"]
    for r in a:
        _check_metrics(r["metrics"], ("loss", "reward", "grad_norm"))
        if r["launches"] != r["launches_want"] or r["launches_by_route"].get("mma") != r["launches"]:
            raise AssertionError(f"(a) rank launches {r['launches']} ({r['launches_by_route']}), "
                                 f"want {r['launches_want']} on mma")
        if not (r["resumed"] and r["resume_bit_equal"] and r["checkpoints"] == ["checkpoint-1"]):
            raise AssertionError(f"(a) checkpoint / resume: {r['checkpoints']} resumed "
                                 f"{r['resumed']} bit-equal {r['resume_bit_equal']}")
        if not r["params_finite"]:
            raise AssertionError("(a) a post-update parameter is not finite")
    if a[0]["param_sum"] != a[1]["param_sum"]:
        raise AssertionError(f"(a) post-update parameters differ: {a[0]['param_sum']} "
                             f"{a[1]['param_sum']}")
    g = a[0]["grad_check"]
    dp_norm, one_norm = g["grad_norm"]
    if (g["rows"] != DIST_SD_PPO_ROWS * (DIST_SD_PPO_N - 1)
            or not g["max_rel_err"] <= DIST_GRAD_RTOL
            or not abs(dp_norm - one_norm) <= DIST_GRAD_RTOL * one_norm):
        raise AssertionError(f"(a) data-parallel vs one-process update of the same batch: {g}")
    if a[0]["actions_agree"] < DIST_ACTIONS_AGREE or a[0]["reward_rel_diff"] > DIST_REWARD_RTOL:
        raise AssertionError(f"(a) data-parallel vs one-process step: actions agree "
                             f"{a[0]['actions_agree']}, reward rel diff {a[0]['reward_rel_diff']}")
    want_edit = DIT_LAUNCHES * FLUX_STEPS + 2 * FLUX_VAE_LAUNCHES
    want_collectives = 2 * 19 + 38 + 1  # per double block, per single block, the final proj_out
    for r in result["flux_tp"]:
        fwd = r["forward"]
        if not all(r["split"].get(kind) for kind in ("column", "row", "gathered")):
            raise AssertionError(f"(b) the DiT was not split: {r['split']}")
        if not fwd["finite"] or fwd["max_abs_diff"] > DIST_DIT_LIMIT * fwd["ref_max_abs"]:
            raise AssertionError(f"(b) TP-2 DiT forward vs unsharded: {fwd}")
        if fwd["collectives"] != {"all_reduce": want_collectives, "all_gather": want_collectives}:
            raise AssertionError(f"(b) TP collectives {fwd['collectives']}, want "
                                 f"{want_collectives} each")
        if (fwd["launches"] != DIT_LAUNCHES or r["edit_launches"] != want_edit
                or r["edit_launches_by_route"].get("mma") != want_edit):
            raise AssertionError(f"(b) launches {fwd['launches']} / {r['edit_launches']} "
                                 f"({r['edit_launches_by_route']}), want {DIT_LAUNCHES} / "
                                 f"{want_edit} on mma")
    b0 = result["flux_tp"][0]
    if b0["edit_shape"] != [1024, 1024, 3] or b0["edit_max_diff"] > DIST_EDIT_MAX_LEVELS:
        raise AssertionError(f"(b) TP-2 edit vs unsharded: {b0}")
    want_serve = DIST_SERVE_BATCHES * LAUNCHES_PER_GENERATION
    for r in result["serve"]:
        if r["launches"] != want_serve or r["launches_by_route"].get("mma") != want_serve:
            raise AssertionError(f"(c) launches {r['launches']} ({r['launches_by_route']}), "
                                 f"want {want_serve} on mma")
    c0 = result["serve"][0]
    if (c0["batches"] != DIST_SERVE_BATCHES or not c0["equal_batch4"]
            or not c0["equal_batch8"]):
        raise AssertionError(f"(c) sharded engine vs unsharded: {c0}")



def _kernel1_entry(rows, runs_by_path):
    """Kernel #1's line.  Its top-level numbers are per SD-1.5 generation
    (batch 8, 8 steps): the launches of that run, and each of its shapes
    timed alone times its launches there.  ``by_path`` has the same numbers
    for the SD-1.5 generation, one FLUX-Kontext edit and one SD3.5 Large
    preview, with the
    launches per route ("mma" or "fma") of that run, and for the PPO runs
    (SD: the two ``fit`` steps; FLUX: one step; both with their reward's
    backbone) their launches per route and the kernel's device time in one
    profiled step.  ``reward_backbones`` has, per backbone call, the
    launches of ``phase_reward_backbones`` and its shapes' times times their
    launches; ``eval`` the launches of ``phase_eval``'s consistency run, FID
    and PCA map."""
    per_run = [r for r in rows if r["dtype"] == "bfloat16" and r["per_generation"]]
    by_path = {}
    for path, key in (("sd", "sd15_generation"), ("flux", "flux_kontext_edit"),
                      ("sd35", "sd35_preview")):
        sel = [r for r in per_run if r["path"] == path]
        entry = {name: sum(r[name] * r["per_generation"] for r in sel)
                 for name in ("ms", "plain_ms", "bound_ms", "library_ms")}
        ops_ms = sum(r["bound_ms"] * r["per_generation"] for r in sel
                     if r["bound_by"] == "operations")
        entry["bound_by"] = "operations" if ops_ms >= entry["bound_ms"] / 2 else "bytes"
        entry["launches"] = runs_by_path[path]["launches"]
        entry["launches_by_route"] = runs_by_path[path]["launches_by_route"]
        entry["launches_by_design"] = runs_by_path[path]["launches_by_design"]
        entry["tflops"] = (sum(4.0 * r["q"][0] * r["q"][1] * r["q"][2] * r["q"][3] * r["sk"]
                               * r["per_generation"] for r in sel) / (entry["ms"] * 1e9))
        entry["ms_over_library"] = entry["ms"] / entry["library_ms"]
        entry["ms_over_bound"] = entry["ms"] / entry["bound_ms"]
        by_path[key] = entry
    for path, key in (("sd_ppo", "sd_ppo_step"), ("flux_ppo", "flux_ppo_step")):
        run = runs_by_path[path]
        by_path[key] = {
            "launches": run["launches"], "launches_by_route": run["launches_by_route"],
            "num_inference": run["num_inference"], "batch": run["batch"],
            "profiled_step": {k: run["profiled_step"][k] for k in (
                "num_inference", "launches_want", "flash_kernel_ms", "flash_share_of_device_time",
                "device_busy_ms", "device_idle_share")},
        }
    backbones = {}
    for name, batch, _, cases in BACKBONES:
        run = runs_by_path["backbones"]["backbones"][name]
        sel = [r for r in per_run if r["case"] in cases]
        backbones[name] = {
            "batch": batch, "launches": run["launches_per_call"],
            "launches_by_route": run["launches_by_route"],
            **{k: sum(r[k] * r["per_generation"] for r in sel)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
    by_path["reward_backbones"] = {**backbones, "per": "one call of each backbone"}
    run = runs_by_path["eval"]
    by_path["eval"] = {"consistency": run["consistency_launches"],
                       "consistency_by_route": run["consistency_by_route"],
                       "fid": run["fid_launches"], "dino_vis": run["dino_vis_launches"],
                       "per": f"{EVAL_PAIRS} pairs; {FID_IMAGES} + {FID_IMAGES} FID images; "
                              "one PCA map"}
    serve = runs_by_path["serve"]
    by_path["serve_sd"] = {**serve["serve_sd"], "per": f"{SERVE_ROUNDS} batches of {BATCH} requests"}
    by_path["serve_edit"] = {**serve["serve_edit"], "per": "one /v1/edit (fmppo, 5 steps)"}
    for label in QUANT_SKIP:
        run = runs_by_path["int8_sd"][label]
        by_path[f"int8_sd_{label}_generation"] = {
            k: run[k] for k in ("launches", "launches_by_route", "int_mm_per_generation")}
    for key in ("int8", "int4"):
        run = runs_by_path["int8_flux"][key]
        by_path[f"{key}_flux_edit"] = {k: run[k] for k in ("launches", "launches_by_route",
                                                           "int_mm_per_edit")}
    run = runs_by_path["sd_ppo"]["int8_ppo"]
    by_path["int8_sd_ppo_step"] = {k: run[k] for k in ("launches", "launches_by_route",
                                                       "num_inference", "int_mm_launches")}
    run = serve["int8"]
    by_path["serve_int8"] = {"generate_rounds": run["throughput"]["launches"],
                             "edit": run["edit"]["launches"],
                             "edit_resize_launches_by_route": run["edit"]["resize_launches_by_route"],
                             "per": f"2 batches of {BATCH} requests; one /v1/edit"}
    run = runs_by_path["dist"]
    by_path["dist"] = {
        "per_rank": {part: [r["launches"] for r in run[part]] for part in ("sd_ppo", "serve")},
        "flux_tp_per_rank": [{"forward": r["forward"]["launches"], "edit": r["edit_launches"]}
                             for r in run["flux_tp"]],
        "backend": run["backend"],
        "per": "(a) one DP PPO step (n = 6, 80 rows a rank); (b) one TP-2 DiT forward and one "
               "edit; (c) two DP serving batches of 8"}
    run = runs_by_path["cli"]
    by_path["cli_generate"] = {k: run["generate"][k] for k in ("launches", "launches_by_route")}
    by_path["cli_generate"]["per"] = f"one generate command: {BATCH} prompts, {STEPS} steps"
    for key, part, per in (("cli_train_sd", "train_sd", "train-sd: 2 steps of batch 80"),
                           ("cli_train_flux", "train_flux",
                            f"train-flux: 1 step of batch {CLI_FLUX_PAIRS}, DiT "
                            f"{CLI_FLUX_DOUBLE} + {CLI_FLUX_SINGLE} blocks")):
        by_path[key] = {"launches": run[part]["launches"],
                        "launches_by_route": run[part]["launches_by_route"],
                        "num_inference": [r["num_inference"] for r in run[part]["steps"]],
                        "per": per}
    run = runs_by_path["learning"]["checks"]
    by_path["learning_checks"] = {
        **{check: {k: r[k] for k in ("launches", "launches_by_route", "steps")}
           for check, r in run.items()},
        "per": "one whole check: the teacher and every PPO step (tiny f32 stacks)"}
    run = runs_by_path["serve_cli"]
    by_path["serve_cli_generate"] = {
        **{k: run["generate"][k] for k in ("launches", "launches_by_route", "batches")},
        "per": f"{SERVE_CLI_ROUNDS} rounds of {BATCH} concurrent requests"}
    by_path["serve_cli_edit"] = {
        **{k: run["edit"][k] for k in ("launches", "launches_by_route")},
        "per": f"one /v1/edit, DiT {CLI_FLUX_DOUBLE} + {CLI_FLUX_SINGLE} blocks"}
    run = runs_by_path["lora"]["generation"]
    by_path["lora_generation"] = {
        **{k: run[k] for k in ("launches", "launches_by_route")},
        "per": f"one generation of {BATCH} with the LoRA-merged UNet"}
    run = runs_by_path["generate_edit"]["by_batch_size"]
    by_path["generate_edit"] = {
        **{f"batch_size_{bs}": {k: r[k] for k in ("launches", "launches_by_route",
                                                   "pipeline_calls")}
           for bs, r in run.items()},
        "per": f"{len(GENERATE_EDIT_SOURCES)} examples, DiT {CLI_FLUX_DOUBLE} + "
               f"{CLI_FLUX_SINGLE} blocks"}
    sd = by_path["sd15_generation"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "consolver_torch/csrc/flash_attention.cu",
        "replaces": "consolver_tpu/kernels/flash_attention.py:67",
        "launches": sd["launches"], "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{name: sd[name] for name in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "kernel_route": max(sd["launches_by_route"], key=sd["launches_by_route"].get),
        "launches_by_route": sd["launches_by_route"],
        "per": "sd15_generation", "by_path": by_path,
    }


def _variant_entry(name, rows, launches, launches_by_route):
    """A variant's line: times at the serving shape, the probe's launches
    (and per kernel route: "mma" or "fma" for bf16 / nomask, "imma" for
    int8).  For int8, ``ms`` is the kernel's launch alone (``kernel_ms``),
    beside the wrapper's ``wrapper_ms`` and its ``quant_ms``, and the rate is
    in TOP/s."""
    mine = [r for r in rows if r["kernel"] == name]
    serve = next(r for r in mine if r["case"] == "serve")
    entry = {
        "name": name, "route": "cuda", "source": "consolver_torch/csrc/flash_variants.cu",
        "replaces": VARIANT_SOURCES[name], "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": serve.get("kernel_ms", serve["ms"]), "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "kernel_route": serve["route"], "launches_by_route": launches_by_route,
        "ms_over_library": serve["ms_over_library"], "ms_over_bound": serve["ms_over_bound"],
        "at": {"q": serve["q"], "block_q": serve["block_q"], "block_k": serve["block_k"]},
    }
    if "kernel_ms" in serve:
        entry.update(wrapper_ms=serve["ms"], quant_ms=serve["quant_ms"], tops=serve["tops"])
    else:
        entry["tflops"] = serve["tflops"]
    return entry


def _resize_entry(phase, serve):
    """The reference crop-resize kernel's line: its device time and bound at
    the 17 Kontext source sizes (the largest of each, from ``phase_resize``),
    the host path's mean time, and its launches on the main path, one per
    ``/v1/edit`` (``serve_edit``; the int8 edit's in ``by_path``)."""
    rows = phase["rows"]
    launches_by_route = serve["serve_edit"]["resize_launches_by_route"]
    return {
        "name": "lanczos_crop_resize", "route": "cuda", "source": "consolver_torch/csrc/resize.cu",
        "replaces": None, "host_path": "consolver_torch/data/edit_prep.py::center_crop_resize",
        "launches": launches_by_route["card"], "launches_by_route": launches_by_route,
        "per": "one /v1/edit", "bit_equal": all(r["bit_equal"] for r in rows),
        "ms": max(r["kernel_ms"] for r in rows), "bound_ms": max(r["bound_ms"] for r in rows),
        "bound_by": "bytes", "ms_over_bound": max(r["kernel_over_bound"] for r in rows),
        "host_ms": phase["host_ms_mean"], "at": f"{len(rows)} source sizes to {phase['size']}^2",
    }


def main() -> int:
    if not (ROOT / "consolver_torch" / "csrc" / "flash_attention.cu").exists():
        print("chip_smoke.py needs the repository around it (consolver_torch/)", file=sys.stderr)
        return 2
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from consolver_torch.kernels import flash_attention as fa
    from consolver_torch.kernels import flash_variants as fv
    from consolver_torch.kernels import resize as rz

    torch.manual_seed(SEED)  # the policy's default-initialised hidden layers

    def timed_build(module):
        t0 = time.perf_counter()
        module.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:  # one nvcc per source, all at once
        build_s = dict(zip(("flash_attention", "flash_variants", "resize"),
                           pool.map(timed_build, (fa, fv, rz))))
    build_s["all"] = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"phase": "build", "build_s": build_s, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    phase_image_io()
    resize_phase = phase_resize(rz)
    phase_kernel1_build(fa)
    with torch.inference_mode():
        rows = phase_kernel(fa)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    phase_mma_kernel(fv)
    phase_imma_kernel(fv)
    with torch.inference_mode():
        variant_rows = phase_variants(fv)
    probe = phase_probe(fv)
    runs_by_path = {"sd": phase_main_path(fa)}
    phase_tiny_slice(fa)
    runs_by_path["flux"] = phase_flux(fa)
    phase_tiny_flux(fa)
    runs_by_path["sd35"] = phase_sd35(fa)
    phase_quant_ops()
    runs_by_path["int8_sd"] = phase_int8_sd(fa)
    runs_by_path["int8_flux"] = phase_int8_flux(fa)
    phase_tiny_quant(fa)
    runs_by_path["backbones"] = phase_reward_backbones(fa)
    phase_tiny_backbones(fa)
    runs_by_path["eval"] = phase_eval(fa)
    runs_by_path["sd_ppo"] = phase_sd_ppo(fa)
    runs_by_path["flux_ppo"] = phase_flux_ppo(fa)
    phase_tiny_train(fa)
    phase_policy_variants()
    with tempfile.TemporaryDirectory(prefix="consolver_smoke_") as work:
        learning = start_learning_checks(work)
        try:
            runs_by_path["cli"] = phase_cli(fa, work)
            runs_by_path["learning"] = phase_learning(learning)
        finally:
            stop_learning_checks(learning)
        runs_by_path["serve_cli"] = phase_serve_cli(fa, runs_by_path["cli"])
        runs_by_path["generate_edit"] = phase_generate_edit(fa, runs_by_path["cli"], work)
    runs_by_path["lora"] = phase_lora(fa)
    runs_by_path["serve"] = phase_serve(fa, runs_by_path)
    runs_by_path["dist"] = phase_dist(fa, runs_by_path["flux"]["dist_ref"])

    kernels = [_kernel1_entry(rows, runs_by_path)]
    kernels += [_variant_entry(k.__name__, variant_rows, probe["launches"][k.__name__],
                               probe["launches_by_route"][k.__name__]) for k in fv.KERNELS]
    kernels.append(_resize_entry(resize_phase, runs_by_path["serve"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
