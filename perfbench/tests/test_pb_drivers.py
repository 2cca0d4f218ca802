"""Each driver end to end on a tiny stack on the CPU, through the harness's
internal ``run_cell`` (never the measuring command): a server, the load
generator in its own process, the window, the metric readers and the check
against the plain reference."""

import math

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

CELLS = ["sd15-preview-poisson", "sd15-preview-lone", "flux-kontext-edit-serial"]


def _run(cell, seed, trace=False, seconds=2.0):
    wl, cfg = tiny.cell(cell)
    return run.run_cell(cell, wl, cfg, tiny.bench(), seed, seconds, trace, torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(cell):
    out = _run(cell, 2**31 + 77)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in run.cell_metrics(tiny.bench(), cell, "end_to_end")}
    assert set(out["metrics"]) == names
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "compared"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_run_reports_per_layer_metrics():
    out = _run("sd15-preview-poisson", 5, trace=True)
    assert out["correct"]
    # on the CPU no device operation runs: the device readers read nothing
    assert set(out["metrics"]) == {"serve.queue_wait_ms.preview", "serve.occupancy.preview",
                                   "pipeline.dispatch_ms.preview"}
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_open_loop_offers_the_schedule():
    wl, cfg = tiny.cell("sd15-preview-poisson")
    out = run.run_cell("sd15-preview-poisson", wl, cfg, tiny.bench(), 9, 4.0, False,
                       torch.device("cpu"))
    assert out["attempted"] == round(wl["traffic"]["rate_rps"] * 4.0)
