"""The harness measures only on a card: without one it exits with another
code than 0 and prints no result, and a run on the CPU writes no number
under a device metric's name."""

import os
import shutil
import subprocess
import sys

import pytest

from port_bench import run, spec
from port_bench.tests.small import small_cell

ARGS = ["--workload", "headline_1024.fly", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_pb_refuses_without_a_card(no_card, capsys):
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_pb_refuses_with_only_its_own_files(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "port_bench.run", *ARGS],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""


def test_pb_no_device_metric_from_a_cpu_run():
    cell = small_cell("native_1080p.fly")
    r, nums, peak = run.measure(cell, 99, 1e9, False, device="cpu",
                                max_frames=2)
    device = {m["name"] for m in cell.end_to_end + cell.per_layer
              if m["source"] == "device_trace"}
    for trace in (False, True):
        got = run.metric_values(cell, r.rec, trace)
        assert not set(got) & device, got
    assert peak == 0 and r.rec.intervals_ms == []
