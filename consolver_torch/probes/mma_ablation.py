"""Ablations of the tensor-core kernels: ``flash_bf16`` / ``flash_nomask``
and ``flash_int8`` (``csrc/flash_variants.cu``) and kernel #1
(``csrc/flash_attention.cu``).

    python -m consolver_torch.probes.mma_ablation                    # all, on the card
    python -m consolver_torch.probes.mma_ablation --target kernel1   # kernel #1 only

Builds altered copies of a source (one ``nvcc`` each, all at once, into a
temporary directory), loads each in place of the library and times the
wrapper with CUDA events, beside the unaltered kernel, in one process on
one card.

``--target variants`` times :func:`flash_bf16` at the FLUX serving and
training shapes; each copy is held to the plain version with the
per-element limit and the one-ulp share of ``chip_smoke.py``'s variants
phase.  The copies:

* undo one design choice (``design``): a runtime branch on the head dim in
  the unrolled MMA loops; Q in its own tile with 2 blocks per SM; two
  barriers per tile;
* drop one part of the work (``cost``, wrong on purpose, timing only): pass
  1's MMAs, the exponentials; or take ``exp2f`` for ``expf``;
* plant one fault (``mutant``, which the limits must catch): the max of the
  chunk's last 64-key tile in place of the chunk's; ``alpha`` left off
  ``l``.

``--target int8`` times ``int8_mma_kernel`` alone (:func:`launch_int8` on
operands quantized and laid out once) at the same shapes; each copy is held
to the plain version with ``chip_smoke.py``'s int8 gates: one bf16 ulp +
1e-5 + ``2 P max|v| / 127`` at every element, at most 1e-3 of the elements
past one ulp and 1e-5 differing at all.  The copies:

* undo one design choice (``design``): the f32 accumulator in registers
  (2 blocks per SM) in place of shared memory (3 blocks); the int -> float
  conversion of the scores and ``rint`` / float -> int of ``pq`` by exact
  adds of 1.5 * 2^23 (full-rate FADD / IADD) in place of the conversion
  instructions (I2F, FRND, F2I, a quarter of the FP32 rate);
* drop one part of the work (``cost``, wrong on purpose): pass 1's MMAs;
  ``exp2f`` in place of ``expf``;
* plant one fault (``mutant``): the max of the chunk's last 64-key tile in
  place of the chunk's; the K rows in natural order (the score permutation
  dropped, so scores meet the wrong k scales and V rows).

``--target kernel1`` times :func:`flash_attention` on bf16 inputs (the
"mma" route) at the FLUX and SD3.5 joint shapes and SD-1.5's level-0
self-attention (design H) and its level-2 self-attention (design A); each
copy is held to the f32 plain version with
``chip_smoke.py``'s kernel #1 limit, one bf16 ulp + 1e-5 at every element.
The copies:

* undo one design choice (``design``): every width of design A held to 2
  blocks per SM (more registers, fewer warps); design H's consumer
  warpgroups issuing their MMAs without taking turns (no ping-pong); its
  exponentials by ``exp2f`` (subnormal results kept) in place of
  ``ex2.approx.ftz``; a 3-stage K / V ring in place of 2;
* drop one part of the work (``cost``, wrong on purpose): the ``p_lo`` MMAs
  of design A, and of design H, so ``p`` enters ``p v`` as one bf16 value:
  what the split costs, and the gate it must fail;
* plant one fault (``mutant``): ``alpha`` left off design A's accumulator,
  and off design H's.

Every edit is a literal replacement in the current source and must apply
exactly once (:func:`altered_sources`), so the ablations cannot drift.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from consolver_torch.kernels import _nvcc
from consolver_torch.kernels import flash_attention as fa
from consolver_torch.kernels import flash_variants as fv

SHAPES = {"serve": (1, 8704, 24, 128), "train": (8, 2560, 24, 128)}
BLOCK_K = 512
KERNEL1_SHAPES = {"flux_joint": (1, 8704, 24, 128), "sd35_joint": (2, 4429, 38, 64),
                  "sd_l0_self": (16, 4096, 8, 40), "sd_l2_self": (16, 256, 8, 160)}

_ONE_BARRIER = """    cp_async_wait<0>();
    __syncthreads();  // this tile has arrived; every warp is done with the other stage
    if (nxt.c0 < p.sk) issue(stage ^ 1, nxt);  // in flight while this tile is multiplied
    cp_async_commit();
"""
_TWO_BARRIERS = """    if (nxt.c0 < p.sk) issue(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
"""
_Q_OWN_TILE = [
    ("constexpr int kMmaSmem = 4 * kTileElems * 2;",
     "constexpr int kMmaSmem = 5 * kTileElems * 2;"),
    ("  bf16* qtile = ring + 2 * kTileElems;", "  bf16* qtile = ring + 4 * kTileElems;"),
    ("__launch_bounds__(kMmaThreads, 3) bf16_mma_kernel",
     "__launch_bounds__(kMmaThreads, 2) bf16_mma_kernel"),
]
_PV_EXP = "const float pr = expf(s[j][e] - m[e >> 1]);"

# name -> (kind, [(old, new), ...])
ABLATIONS = {
    "d_branch": ("design", [
        ("const bf16* kt, int lane) {", "const bf16* kt, int lane, int dpad) {"),
        ("  for (int kk = 0; kk < DP / 16; ++kk) {\n"
         "#pragma unroll\n    for (int jp = 0; jp < 4; ++jp) {",
         "  for (int kk = 0; kk < DP / 16; ++kk) {\n    if (kk * 16 >= dpad) break;\n"
         "#pragma unroll\n    for (int jp = 0; jp < 4; ++jp) {"),
        ("    tile_scores(s, qf, kt, lane);",
         "    tile_scores(s, qf, kt, lane, (p.d + 15) & ~15);"),
        ("        for (int jp = 0; jp < DP / 16; ++jp) {  // output columns 16jp..16jp+15\n",
         "        for (int jp = 0; jp < DP / 16; ++jp) {  // output columns 16jp..16jp+15\n"
         "          if (jp * 16 >= ((p.d + 15) & ~15)) break;\n"),
    ]),
    "q_own_tile_2_blocks": ("design", _Q_OWN_TILE),
    "two_barriers": ("design", _Q_OWN_TILE + [
        (_ONE_BARRIER, _TWO_BARRIERS),
        ("    cur = nxt;\n    stage ^= 1;",
         "    __syncthreads();\n    cur = nxt;\n    stage ^= 1;"),
    ]),
    "no_pass1_mma": ("cost", [
        ("    tile_scores(s, qf, kt, lane);",
         "    if (cur.pass == 1) tile_scores(s, qf, kt, lane);\n"
         "    else for (auto& r : s) r[0] = r[1] = r[2] = r[3] = 0.f;"),
    ]),
    "no_exp": ("cost", [(_PV_EXP, "const float pr = s[j][e] - m[e >> 1];")]),
    "exp2f": ("cost", [(_PV_EXP, "const float pr = exp2f((s[j][e] - m[e >> 1]) * 1.44269504f);")]),
    "max_per_tile": ("mutant", [("      if (cur.t0 == 0) mx[0] = mx[1] = kNegInf;",
                                 "      mx[0] = mx[1] = kNegInf;")]),
    "no_alpha_on_l": ("mutant", [("          l[r] = l[r] * alpha[r] + x;",
                                  "          l[r] = l[r] + x;")]),
}


_ACC_ALPHA_A = """    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
"""

_O_ALPHA_H = """#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
"""

KERNEL1_ABLATIONS = {
    "min_blocks_2": ("design", [
        ("return dp <= 48 ? 4 : dp <= 128 ? 3 : 2;", "return 2;"),
    ]),
    "no_p_lo": ("cost", [
        ("        mma_bf16(acc[2 * jp], plo, bv[0], bv[1]);\n"
         "        mma_bf16(acc[2 * jp + 1], plo, bv[2], bv[3]);\n", ""),
    ]),
    "no_alpha_on_acc": ("mutant", [(_ACC_ALPHA_A, "")]),
    "h_no_pingpong": ("design", [
        ("    if (wg == 1) named_arrive(1, 256);  // warpgroup 0 issues first\n", ""),
        ("    named_sync(turn, 256);\n    issue_scores(0);\n", "    issue_scores(0);\n"),
        ("    if (wg == 0 || ntiles > 1) named_arrive(next, 256);\n", ""),
        ("      named_sync(turn, 256);\n      issue_scores(st);\n", "      issue_scores(st);\n"),
        ("      if (wg == 0 || j < ntiles - 1) named_arrive(next, 256);\n", ""),
    ]),
    "h_exp2f": ("design", [("const float pr = ex2_ftz(fmaf(", "const float pr = exp2f(fmaf(")]),
    "h_3_stages": ("design", [("constexpr int kStagesH = 2;", "constexpr int kStagesH = 3;")]),
    "h_no_p_lo": ("cost", [
        ("          wgmma_rs_m64n64(o, plo[kk], dv);\n", ""),
        ("          wgmma_rs_m64n128(o, plo[kk], dv);\n", ""),
    ]),
    "h_no_alpha_on_o": ("mutant", [(_O_ALPHA_H, "")]),
}

_I8_EXP = "const float pr = expf(__fsub_rn(s[j][e], m[e >> 1]));"

INT8_ABLATIONS = {
    "acc_in_registers": ("design", [
        ("constexpr int kI8Blocks = 3;", "constexpr int kI8Blocks = 2;"),
        ("constexpr int kI8AccBytes = BQ * DP * 4;", "constexpr int kI8AccBytes = 0;"),
        ("  auto acc = [&](int j, int e) -> float& { return acc_s[(4 * j + e) * kMmaThreads + "
         "threadIdx.x]; };",
         "  float acc_r[DP / 8][4];\n"
         "  auto acc = [&](int j, int e) -> float& { return acc_r[j][e]; };"),
    ]),
    # exact for |x| < 2^22 and 0 <= y < 2^22: 1.5 * 2^23 + x is a float, and
    # y + 1.5 * 2^23 rounds half to even at 1, as rintf; pack_s8 takes the low byte
    "magic_conversions": ("design", [
        ("__fmul_rn(__fmul_rn(static_cast<float>(si[j][e]), qmul[e >> 1]),",
         "__fmul_rn(__fmul_rn(__fsub_rn(__int_as_float(0x4B400000 + si[j][e]), 12582912.f), "
         "qmul[e >> 1]),"),
        ("          pq[j][e] = static_cast<int>(rintf(__fmul_rn(pr, 127.f)));\n"
         "          qsum[e >> 1] += pq[j][e];",
         "          pq[j][e] = __float_as_int(__fadd_rn(__fmul_rn(pr, 127.f), 12582912.f));\n"
         "          qsum[e >> 1] += pq[j][e] - 0x4B400000;"),
    ]),
    "no_pass1_mma": ("cost", [
        ("    tile_scores_i8(si, qf, st, lane);",
         "    if (cur.pass == 1) tile_scores_i8(si, qf, st, lane);\n"
         "    else for (auto& r : si) r[0] = r[1] = r[2] = r[3] = 0;"),
    ]),
    "exp2f": ("cost", [(_I8_EXP, "const float pr = exp2f(__fsub_rn(s[j][e], m[e >> 1]) * "
                                 "1.44269504f);")]),
    "max_per_tile": ("mutant", [("      if (cur.t0 == 0) rmax[0] = rmax[1] = kNegInf;",
                                 "      rmax[0] = rmax[1] = kNegInf;")]),
    "no_k_permutation": ("mutant", [
        ("  const int key = 4 * ((lane >> 1) & 3) + 2 * (lane >> 4) + (lane & 1);",
         "  const int key = (lane & 7) + ((lane >> 4) << 3);"),
    ]),
}

_VARIANT_ENTRIES = ("consolver_flash_variant_forward", "consolver_flash_mma_occupancy",
                    "consolver_flash_imma_occupancy")

# target -> (wrapper module, ablations of its source, the library's entry points)
TARGETS = {
    "variants": (fv, ABLATIONS, _VARIANT_ENTRIES),
    "int8": (fv, INT8_ABLATIONS, _VARIANT_ENTRIES),
    "kernel1": (fa, KERNEL1_ABLATIONS,
                ("consolver_flash_attention_forward", "consolver_flash_attention_mma_info")),
}


def altered_sources(target: str = "variants") -> dict:
    """Each ablation's source; raises unless every edit applies exactly once."""
    module, ablations, _ = TARGETS[target]
    source = module._SOURCE.read_text()
    out = {"kernel": source}
    for name, (_, edits) in ablations.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"ablation {name}: edit does not apply once: {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(workdir: Path, name: str, source: str, filename: str) -> ctypes.CDLL:
    d = workdir / name
    d.mkdir()
    (d / filename).write_text(source)
    for header in _nvcc.CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    lib = d / "lib.so"
    proc = subprocess.run(
        [_nvcc.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(d / filename)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on ablation {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _heaviest(q, k):
    heaviest = 0.0
    for h in range(q.shape[2]):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(), k[:, :, h].float()) / q.shape[-1] ** 0.5
        heaviest = max(heaviest, torch.exp(s.amax(-1) - torch.logsumexp(s, -1)).max().item())
    return heaviest


def _within_limits(out, ref, q, k, v, int8=False):
    """chip_smoke's variant limits: the worst element over its limit (one
    bf16 ulp + 1e-5 + one flip of the heaviest p: ``2^-7 P max|v|``, int8
    ``2 P max|v| / 127``), the share of elements past one ulp and the share
    differing at all."""
    vmax = v.float().abs().max().item()
    flip = (2.0 / 127 if int8 else 2.0**-7) * _heaviest(q, k) * vmax
    diff = (out.float() - ref.float()).abs()
    ulp = 2.0**-7 * ref.float().abs() + 1e-5
    return ((diff / (ulp + flip)).max().item(), (diff > ulp).float().mean().item(),
            (diff > 0).float().mean().item())


def run(iters: int = 10, seed: int = 0, log=print, target: str = "variants") -> dict:
    """Builds every copy of ``target``'s source, then times and checks each
    at its shapes."""
    if not torch.cuda.is_available():
        raise RuntimeError("mma_ablation runs on a CUDA card only")
    module, _, entries = TARGETS[target]
    real = module.build()
    sources = altered_sources(target)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: _build(Path(tmp), *kv, module._SOURCE.name),
                                          sources.items())))
        for lib in libs.values():
            for fn in entries:
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        gen = torch.Generator(device="cuda").manual_seed(seed)
        try:
            if target == "variants":
                return _run_variants(libs, real, iters, gen, log)
            if target == "int8":
                return _run_int8(libs, real, iters, gen, log)
            return _run_kernel1(libs, iters, gen, log)
        finally:
            module._library = real


def _run_variants(libs, real, iters, gen, log) -> dict:
    results = {}
    for shape_name, shape in SHAPES.items():
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        fv._library = real
        ref = fv.flash_bf16_reference(q, k, v, block_k=BLOCK_K)
        for name, lib in libs.items():
            fv._library = lib
            out = fv.flash_bf16(q, k, v, block_k=BLOCK_K)
            worst, past, _ = _within_limits(out, ref, q, k, v)
            del out
            ms = _time_ms(lambda: fv.flash_bf16(q, k, v, block_k=BLOCK_K), iters)
            kind = ABLATIONS[name][0] if name in ABLATIONS else "kernel"
            row = {"ablation": name, "kind": kind, "shape": shape_name, "ms": ms,
                   "err_over_limit": worst, "share_past_one_ulp": past,
                   "passes_limits": worst <= 1.0 and past <= 1e-3}
            results[f"{shape_name}/{name}"] = row
            log(json.dumps(row))
        del q, k, v, ref
    return results


def _run_int8(libs, real, iters, gen, log) -> dict:
    """The int8 kernel's copies: the launch alone on operands quantized and
    laid out once, against flash_int8_reference with the int8 gates."""
    results = {}
    for shape_name, shape in SHAPES.items():
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        ref = fv.flash_int8_reference(q, k, v, block_k=BLOCK_K)
        ops = fv.int8_kernel_operands(*fv.quantize_int8(q, k, v))
        for name, lib in libs.items():
            fv._library = lib
            out = fv.launch_int8(ops, q.dtype, BLOCK_K)
            worst, past, differing = _within_limits(out, ref, q, k, v, int8=True)
            del out
            ms = _time_ms(lambda: fv.launch_int8(ops, q.dtype, BLOCK_K), iters)
            kind = INT8_ABLATIONS[name][0] if name in INT8_ABLATIONS else "kernel"
            b, s, h, d = shape
            row = {"target": "int8", "ablation": name, "kind": kind, "shape": shape_name, "ms": ms,
                   "tops": 4.0 * b * h * s * s * d / (ms * 1e9), "err_over_limit": worst,
                   "share_past_one_ulp": past, "share_differing": differing,
                   "passes_limits": worst <= 1.0 and past <= 1e-3 and differing <= 1e-5}
            results[f"{shape_name}/{name}"] = row
            log(json.dumps(row))
        fv._library = real
        del q, k, v, ref, ops
        torch.cuda.empty_cache()
    return results


def _run_kernel1(libs, iters, gen, log) -> dict:
    """Kernel #1's copies on bf16 inputs against the f32 plain version: the
    worst element's error over one bf16 ulp + 1e-5."""
    results = {}
    for shape_name, (b, s, h, d) in KERNEL1_SHAPES.items():
        q, k, v = (torch.randn((b, s, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
        limit = 2.0**-7 * ref.abs() + 1e-5
        for name, lib in libs.items():
            fa._library = lib
            before = fa.flash_attention.launches_by_route["mma"]
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            if fa.flash_attention.launches_by_route["mma"] != before + 1:
                raise RuntimeError(f"kernel #1 copy {name} did not take the mma route")
            worst = ((out.float() - ref).abs() / limit).max().item()
            del out
            ms = _time_ms(lambda: fa.flash_attention(q, k, v), iters)
            kind = KERNEL1_ABLATIONS[name][0] if name in KERNEL1_ABLATIONS else "kernel"
            row = {"target": "kernel1", "ablation": name, "kind": kind, "shape": shape_name,
                   "ms": ms, "tflops": 4.0 * b * h * s * s * d / (ms * 1e9),
                   "err_over_limit": worst, "passes_limits": worst <= 1.0}
            results[f"{shape_name}/{name}"] = row
            log(json.dumps(row))
        del q, k, v, ref, limit
        torch.cuda.empty_cache()
    return results


def _time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--target", choices=(*TARGETS, "all"), default="all")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("no CUDA device: the ablations build and time CUDA kernels")
    for target in TARGETS if args.target == "all" else (args.target,):
        run(args.iters, target=target)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
