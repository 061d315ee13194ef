"""``correct`` comes out false when the timed path is broken underneath a
run (on the CPU at a small size, the search for a card skipped), once for
each fault a cell of this renderer can have, and for the control, the
reference in bfloat16 in the port's place.  A cell runs on one chip, so no
exchange between chips can be left out."""

import pytest
import torch

from port_bench import check, run
from port_bench.tests.small import small_cell

torch.set_num_threads(4)
SEED = 2147483647 + 40


def verdict(name, seed=SEED):
    cell = small_cell(name)
    _, nums, _ = run.measure(cell, seed, 1e9, False, device="cpu",
                             max_frames=2)
    return check.verdict(nums, cell.limits), nums


def gi_unchanged(monkeypatch):
    """A step that returns its state unchanged: the GI update."""
    from rvgrt_tpu_torch.gi import update

    def frozen(gi, *a, return_stats=False, **k):
        st = {"straggler_overflow": torch.zeros((), dtype=torch.int32)}
        return (gi, st) if return_stats else gi
    monkeypatch.setattr(update, "update_gi", frozen)


def history_unchanged(monkeypatch):
    """A step that returns its state unchanged: the accumulator."""
    from rvgrt_tpu_torch.upscale import temporal

    def frozen(color, motion, depth, jitter, state, **k):
        return state.history, state
    monkeypatch.setattr(temporal, "temporal_upscale", frozen)


def half_the_rays(monkeypatch):
    """Half of the batch left out: the second half of every trace's rays
    read as misses."""
    from rvgrt_tpu_torch.trace import wavefront

    orig = wavefront.trace

    def half(*a, **k):
        res = orig(*a, **k)
        n = res.hit.numel()
        cut = torch.arange(n).reshape(res.hit.shape) >= n // 2
        return res._replace(hit=res.hit & ~cut,
                            t=torch.where(cut, 0.0, res.t))
    monkeypatch.setattr(wavefront, "trace", half)


def altered_pixel(monkeypatch):
    """An answer altered where it is produced: one pixel of the composite
    off by a step of 8 bits."""
    from rvgrt_tpu_torch.render import pipeline

    orig = pipeline.gi_composite

    def off(*a, **k):
        out = orig(*a, **k)
        out = out.clone()
        out[0, 0, 0] = torch.where(out[0, 0, 0] > 0.5, out[0, 0, 0] - 1 / 255,
                                   out[0, 0, 0] + 1 / 255)
        return out
    monkeypatch.setattr(pipeline, "gi_composite", off)


FAULTS = {"gi_unchanged": gi_unchanged, "half_the_rays": half_the_rays,
          "altered_pixel": altered_pixel}


@pytest.mark.parametrize("name", ["headline_1024.fly", "native_1080p.fly"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_pb_fault_fails_the_check(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    ok, nums = verdict(name)
    assert not ok, nums


def test_pb_accumulator_unchanged_fails_the_check(monkeypatch):
    history_unchanged(monkeypatch)
    ok, nums = verdict("headline_1024.fly")
    assert not ok, nums


@pytest.mark.parametrize("name", ["headline_1024.fly", "native_1080p.fly"])
def test_pb_control_fails_the_check(name):
    cell = small_cell(name)
    r, nums, _ = run.measure(cell, SEED, 1e9, False, device="cpu",
                             max_frames=2)
    assert check.verdict(nums, cell.limits)
    low = check.compare(cell, None, r.kept, r.poses, r.rates[:r.n_warm],
                        "cpu", lowp=True)
    assert not check.verdict(low, cell.limits), low
