"""The lower-precision control, on the card: the program's int8 path
(``quantize()``) in the program's place has to come out not correct, and
the served bf16 path correct, at each cell's own size with a short window.
Needs a card; skips here."""

import pytest
import torch

from perfbench import run

# (cell, window): long enough that the closed loop reaches its sampled edit
# at the int8 path's 6 s an edit
CELLS = [("sd15-preview-poisson", 8.0), ("flux-kontext-edit-serial", 40.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", CELLS)
def test_control_fails_and_program_passes(cell, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their published widths")
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    wl = run.load_json(run.BENCH_DIR / "workloads" / f"{cell}.json")
    cfg = run.load_json(run.BENCH_DIR / "configs" / f"{wl['config']}.json")
    device = torch.device("cuda", 0)
    sound = run.run_cell(cell, wl, cfg, bench, 4242, seconds, False, device)
    assert sound["correct"], sound["compared"]
    control = run.run_cell(cell, wl, cfg, bench, 4242, seconds, False, device,
                           variant="int8")
    assert not control["correct"], control["compared"]
