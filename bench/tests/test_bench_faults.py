"""The check catches a broken timed path: the whole harness path at the
tiny size of each cell, with one of the faults the cell can have (the
generic ones of ``bench.faults`` and its family's) planted in the
program underneath, comes out not correct. A fault of the host pool's
prefix blocks is planted only where the cell's mix shares prefixes."""
import pytest
import torch

from bench import faults, run, spec
from conftest import CELLS, reuses

SEED = 2 ** 31 + 21
CASES = [(c, f) for c in CELLS
         for f in sorted(faults.points(spec.find_cell(c)))
         if f != "pool_prefix_wrong" or reuses(c)]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_comes_out_not_correct(tiny_cell, name, fault):
    cell, cfg = tiny_cell(name)
    with faults.plant(fault, cell):
        out = run.execute(cell, SEED, 4.0, False, torch.device("cpu"),
                          cfg=cfg, log=lambda s: None)
    assert out["check"]["sampled"]["value"] >= 3
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_comes_out_correct(tiny_cell, name):
    cell, cfg = tiny_cell(name)
    cell.workload["check"] = dict(cell.workload["check"], requests=100)
    out = run.execute(cell, SEED, 4.0, False, torch.device("cpu"), cfg=cfg,
                      log=lambda s: None)
    assert out["correct"], out["check"]
