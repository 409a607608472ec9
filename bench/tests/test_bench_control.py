"""The control at a size a test run holds: on three seeds of each cell,
the reference computed in fp8 in the program's place comes out not
correct through the same ``check.passes`` and limit, while the
program's served tokens come out correct."""
import pytest
import torch

from bench import run
from conftest import CELLS


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(tiny_cell, name, seed):
    cell, cfg = tiny_cell(name)
    out = run.execute(cell, seed, 4.0, False, torch.device("cpu"), cfg=cfg,
                      control=True, log=lambda s: None)
    limit = out["check"]["max_logit_gap"]["limit"]
    assert out["correct"]
    assert out["check"]["max_logit_gap"]["value"] < limit
    assert out["control_gap"] > limit
    assert not out["control_correct"]
