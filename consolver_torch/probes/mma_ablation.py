"""Ablations of the tensor-core kernel of ``flash_bf16`` / ``flash_nomask``.

    python -m consolver_torch.probes.mma_ablation        # on the card

Builds altered copies of ``csrc/flash_variants.cu`` (one ``nvcc`` each, all
at once, into a temporary directory), loads each in place of the library
and times :func:`flash_bf16` at the FLUX serving and training shapes with
CUDA events, beside the unaltered kernel, in one process on one card.  Each
copy is held to the plain version with the per-element limit and the
one-ulp share of ``chip_smoke.py``'s variants phase.  The copies:

* undo one design choice (``design``): a runtime branch on the head dim in
  the unrolled MMA loops; Q in its own tile with 2 blocks per SM; two
  barriers per tile;
* drop one part of the work (``cost``, wrong on purpose, timing only): pass
  1's MMAs, the exponentials; or take ``exp2f`` for ``expf``;
* plant one fault (``mutant``, which the limits must catch): the max of the
  chunk's last 64-key tile in place of the chunk's; ``alpha`` left off
  ``l``.

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
from consolver_torch.kernels import flash_variants as fv

SHAPES = {"serve": (1, 8704, 24, 128), "train": (8, 2560, 24, 128)}
BLOCK_K = 512

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


def altered_sources() -> dict:
    """Each ablation's source; raises unless every edit applies exactly once."""
    source = fv._SOURCE.read_text()
    out = {"kernel": source}
    for name, (_, edits) in ABLATIONS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"ablation {name}: edit does not apply once: {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(workdir: Path, name: str, source: str) -> ctypes.CDLL:
    d = workdir / name
    d.mkdir()
    (d / fv._SOURCE.name).write_text(source)
    for header in _nvcc.CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    lib = d / "lib.so"
    proc = subprocess.run(
        [_nvcc.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(d / fv._SOURCE.name)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on ablation {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _within_limits(out, ref, q, k, v):
    """chip_smoke's variant limits: the worst element over its limit (one
    bf16 ulp + 1e-5 + one flip of the heaviest p) and the share of elements
    past one ulp."""
    heaviest = 0.0
    for h in range(q.shape[2]):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(), k[:, :, h].float()) / q.shape[-1] ** 0.5
        heaviest = max(heaviest, torch.exp(s.amax(-1) - torch.logsumexp(s, -1)).max().item())
    flip = 2.0**-7 * heaviest * v.float().abs().max().item()
    diff = (out.float() - ref.float()).abs()
    ulp = 2.0**-7 * ref.float().abs() + 1e-5
    return (diff / (ulp + flip)).max().item(), (diff > ulp).float().mean().item()


def run(iters: int = 10, seed: int = 0, log=print) -> dict:
    """Builds every copy, then times and checks each at both shapes."""
    if not torch.cuda.is_available():
        raise RuntimeError("mma_ablation runs on a CUDA card only")
    real = fv.build()
    sources = altered_sources()
    results = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: _build(Path(tmp), *kv), sources.items())))
        for lib in libs.values():
            for fn in ("consolver_flash_variant_forward", "consolver_flash_mma_occupancy"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        gen = torch.Generator(device="cuda").manual_seed(seed)
        try:
            for shape_name, shape in SHAPES.items():
                q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                           for _ in range(3))
                fv._library = real
                ref = fv.flash_bf16_reference(q, k, v, block_k=BLOCK_K)
                for name, lib in libs.items():
                    fv._library = lib
                    out = fv.flash_bf16(q, k, v, block_k=BLOCK_K)
                    worst, past = _within_limits(out, ref, q, k, v)
                    del out
                    ms = _time_ms(lambda: fv.flash_bf16(q, k, v, block_k=BLOCK_K), iters)
                    kind = ABLATIONS[name][0] if name in ABLATIONS else "kernel"
                    row = {"ablation": name, "kind": kind, "shape": shape_name, "ms": ms,
                           "err_over_limit": worst, "share_past_one_ulp": past,
                           "passes_limits": worst <= 1.0 and past <= 1e-3}
                    results[f"{shape_name}/{name}"] = row
                    log(json.dumps(row))
                del q, k, v, ref
        finally:
            fv._library = real
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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("no CUDA device: the ablations build and time CUDA kernels")
    run(args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
