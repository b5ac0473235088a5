"""On the card, at each cell's own size: the TF32 control (the reference
computed in the next precision below the configuration's, in the program's
place) and, for a training cell, the half-batch fault fail the cell's
limits on three seeds, and the program passes (a serving cell; a training
cell's program readings come from its runs)."""

import pytest

from port_bench.core import spec
from port_bench.tests._tiny import cells


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", cells())
def test_control_fails_program_passes(cell_name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from port_bench.control import readings

    limits = spec.checks(cell_name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        prog, ctl = readings(cell_name, seed, True)
        if prog is not None:
            assert all(prog[k] <= lim for k, lim in limits.items()), prog
        assert ctl
        for numbers in ctl.values():
            assert any(numbers[k] > lim for k, lim in limits.items()), numbers
