"""The control of each tiny cell on the CPU: the plain reference computed one
precision step below the configuration's dtype (TF32 for the f32 cells, fp8
for the bf16 ones) in the program's place fails at least one of the cell's
limits, on three seeds. On the card `python benchmark/control.py` reads the
same numbers at the cells' own sizes."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.tiny import TINY_LIMITS


@pytest.mark.parametrize("cell", sorted(TINY_LIMITS))
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
def test_control_fails(tiny_root, cell, seed):
    loaded = harness.load_cell(cell, tiny_root)
    readings = control.readings(loaded, harness.load_config(loaded["config"], tiny_root), seed, torch.device("cpu"))
    assert set(readings) == set(TINY_LIMITS[cell])
    assert any(readings[k] > TINY_LIMITS[cell][k] for k in readings), readings
