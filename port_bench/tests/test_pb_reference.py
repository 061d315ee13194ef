"""The frozen reference (``port_bench/reference/``) computes what the port
computes: each cell's configuration cut to 128^3 and a 64x40 render, the
port run with its plain kernels on the CPU, every number of the check 0,
along the chain from the world with the reference's own state and at a
window frame from the port's."""

import pytest
import torch

from port_bench import check, drive, run
from port_bench.tests.small import small_cell

torch.set_num_threads(4)


@pytest.mark.parametrize("seed", [2147483711, 17])
@pytest.mark.parametrize("name", ["headline_1024.fly", "native_1080p.fly"])
def test_pb_reference_equals_the_port(name, seed):
    cell = small_cell(name)
    r, nums, _ = run.measure(cell, seed, 1e9, False, device="cpu",
                             max_frames=3)
    chain = [drive.chain_key(i) for i in range(drive.CHAIN_FRAMES)]
    assert set(r.kept) == {*chain, "window"}
    assert r.kept["window"].index >= r.n_warm
    assert nums == dict.fromkeys(check.NUMBERS, 0), nums
    assert check.verdict(nums, cell.limits)
