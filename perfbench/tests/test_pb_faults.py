"""The check fails a run whose timed path is broken underneath: the rest of
a run is driven as the benchmark drives it (tiny stacks, on the CPU, past
the look for a card), with one fault planted in the program at a time."""

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny


def _correct(cell, seed=31):
    wl, cfg = tiny.cell(cell)
    return run.run_cell(cell, wl, cfg, tiny.bench(), seed, 2.0, False, torch.device("cpu"))


@pytest.mark.parametrize("cell,fn", [("sd15-preview-poisson", "ddim_update"),
                                     ("flux-kontext-edit-serial", "fm_euler_update")])
def test_step_returning_its_state_unchanged_fails(monkeypatch, cell, fn):
    from consolver_torch.core import solver

    monkeypatch.setattr(solver, fn, lambda sample, *args, **kwargs: sample)
    out = _correct(cell)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", ["sd15-preview-lone", "flux-kontext-edit-serial"])
def test_answer_altered_where_produced_fails(monkeypatch, cell):
    from consolver_torch.serve import engine

    to_uint8 = engine._uint8_in_program

    def altered(images):
        out = to_uint8(images).clone()
        out[:, : out.shape[1] // 4] ^= 32  # a quarter of each image off by 32 levels
        return out

    monkeypatch.setattr(engine, "_uint8_in_program", altered)
    out = _correct(cell)
    assert not out["correct"], out["compared"]


def test_sound_run_is_correct():
    assert _correct("sd15-preview-lone")["correct"]
