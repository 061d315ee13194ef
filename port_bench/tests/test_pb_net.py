"""The harness takes a configuration whose post stage is the learned
upscaler, or whose GI composite runs at a cadence, from its data alone: on
the CPU at 128^3 and 64x40 -> 192x120, the port against the reference's
float32 net (``reference/upscaler.py``) along the chain and at a window
frame; the faults a net can have and the float8 control give ``correct``
false; a composite cadence of 2 is followed exactly."""

import copy
import json

import pytest
import torch

from port_bench import check, run, spec
from port_bench.reference import upscaler as rup
from port_bench.tests import netcells
from port_bench.tests.small import small_cell

torch.set_num_threads(4)
SEED = 2147483647 + 91
NET_SEED = 5
#: the image's gap, port against reference, allowed on the CPU.  Both
#: round each conv's input, kernel, sum and bias to bfloat16; the port's
#: bf16 conv (oneDNN) sums in float32 in another order than the
#: reference's float32 conv, so a sum within half a bf16 ulp of a rounding
#: edge rounds the other way now and then: one bf16 ulp of an activation,
#: carried through the later layers to the rgb residual and the blend
#: logit, about 1e-3 of the image a frame (read on these frames' inputs).
#: Along the chain each side carries its own history, packed to 8 bits a
#: channel by the warp, so such a gap across a quantisation edge comes back
#: as 1/255 and goes through the net again.  Readings over four seeds:
#: 8.4e-3 to 1.7e-2 along the chain; the faults below read 0.61 to 1.0, the
#: control 0.48 to 0.75.
NET_TOL = 0.05


def limits(cell) -> dict:
    return dict(cell.limits, image_err=NET_TOL)


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = tmp_path_factory.mktemp("net")
    netcells.seeded_net(root / "net.pkl", NET_SEED)
    return root


def measure(cell, seed=SEED, frames=3):
    return run.measure(cell, seed, 1e9, False, device="cpu",
                       max_frames=frames)


@pytest.mark.parametrize("which", ["seeded", "repository"])
def test_pb_net_port_equals_the_reference(seeded, which):
    root, net = ((seeded, "net.pkl") if which == "seeded"
                 else (spec.ROOT, netcells.REPO_NET))
    cell = netcells.net_cell(root, net)
    r, nums, _ = measure(cell)
    assert r.kept["window"].index >= r.n_warm
    assert r.kept["window"].state_in.shape == (120, 192, 3)
    assert {k: nums[k] for k in check.NUMBERS[:-1]} == dict.fromkeys(
        check.NUMBERS[:-1], 0), nums
    assert nums["image_err"] <= NET_TOL, nums
    assert check.verdict(nums, limits(cell))


def conv_skipped(monkeypatch):
    """A feature conv skipped: ``feat1`` leaves its input as it is."""
    from rvgrt_tpu_torch.upscale import model

    def logits(self, x):
        for i in range(self.depth_layers):
            if i != 1:
                x = torch.relu(getattr(self, f"feat{i}")(x, self.dtype))
        x = self.shuffle(x, self.dtype)
        return model.depth_to_space_cf(x[0].permute(1, 2, 0), model.SCALE,
                                       self.c_out)
    monkeypatch.setattr(model._ConvStack, "logits", logits)


def history_unchanged(monkeypatch):
    """The net's history left unchanged from frame to frame."""
    from rvgrt_tpu_torch.driver import frame_loop

    post = frame_loop.FrameLoop._post

    def frozen(self, *a):
        state = self.state
        image = post(self, *a)
        self.state = state
        return image
    monkeypatch.setattr(frame_loop.FrameLoop, "_post", frozen)


def alpha_zero(monkeypatch):
    """The blend's alpha forced to 0: the history never enters."""
    from rvgrt_tpu_torch.upscale import model

    blend = model.UpscalerNet.blend

    def no_history(up, color, warped):
        up = up.clone()
        up[3] = -float("inf")
        return blend(up, color, warped)
    monkeypatch.setattr(model.UpscalerNet, "blend",
                        staticmethod(no_history))


FAULTS = {"conv_skipped": conv_skipped,
          "history_unchanged": history_unchanged, "alpha_zero": alpha_zero}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_pb_net_fault_fails_the_check(monkeypatch, seeded, fault):
    FAULTS[fault](monkeypatch)
    cell = netcells.net_cell(seeded, "net.pkl")
    _, nums, _ = measure(cell)
    assert not check.verdict(nums, limits(cell)), nums


def test_pb_net_float8_control_fails(seeded):
    cell = netcells.net_cell(seeded, "net.pkl")
    r, nums, _ = measure(cell)
    assert check.verdict(nums, limits(cell)), nums
    low = check.compare(cell, None, r.kept, r.poses, r.rates[:r.n_warm],
                        "cpu", lowp=True)
    assert not check.verdict(low, limits(cell)), low
    # on the window frame's own inputs the float8 convs alone move the
    # image far more than the port's rounding order does
    w = r.kept["window"]
    net = rup.load(seeded / "net.pkl")
    args = (w.color, w.motion, w.depth,
            torch.as_tensor(w.pose.jitter), w.state_in)
    want = rup.upscale(net, *args)
    fp8 = (rup.upscale(net, *args, lowp_dtype=rup.FP8) - want).abs().max()
    port = (w.image - want).abs().max()
    assert fp8 > 8 * port, (fp8, port)


@pytest.mark.parametrize("seed", [SEED, 23])
def test_pb_cadence_two_equals_the_port(seed):
    cell = netcells.cadence_cell(2)
    r, nums, _ = measure(cell, seed, frames=4)
    window = r.kept["window"]
    assert window.addend_in.shape == (40, 64, 3)
    assert float(window.addend_in.abs().max()) > 0.05  # light is carried
    assert nums == dict.fromkeys(check.NUMBERS, 0), nums


def test_pb_cadence_addend_is_checked(monkeypatch):
    """A reusing frame that re-adds nothing (the addend lost) fails."""
    from rvgrt_tpu_torch.driver import frame_loop

    composite = frame_loop.FrameLoop._composite

    def lost(self, i, color, gb, rate, phase):
        if i % self.comp_cadence:
            self.addend = torch.zeros_like(self.addend)
        return composite(self, i, color, gb, rate, phase)
    monkeypatch.setattr(frame_loop.FrameLoop, "_composite", lost)
    cell = netcells.cadence_cell(2)
    _, nums, _ = measure(cell, frames=4)
    assert not check.verdict(nums, cell.limits), nums


@pytest.mark.parametrize("loop, key", [
    ({"post": "net"}, "loop.net"),
    ({"post": "temporal", "net": netcells.REPO_NET}, "loop.net"),
    ({"post": "net", "net": "/abs/upscaler.pkl"}, "loop.net"),
    ({"post": "net", "net": "../upscaler.pkl"}, "loop.net"),
    ({"post": "net", "net": netcells.REPO_NET, "scale": 1}, "loop.scale"),
    ({"comp_cadence": 0}, "loop.comp_cadence"),
    ({"comp_cadence": 1.5}, "loop.comp_cadence"),
])
def test_pb_a_loop_without_what_it_needs_is_refused_at_load(
        tmp_path, loop, key):
    bench = copy.deepcopy(spec.load_benchmark())
    cfg = copy.deepcopy(small_cell("headline_1024.fly").config)
    cfg["loop"].update(loop)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    bench["configs"][0]["file"] = "cfg.json"
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        spec.Cell(bench, "headline_1024.fly", root=tmp_path)


def test_pb_a_loop_without_the_new_keys_runs_as_before():
    cell = small_cell("headline_1024.fly")
    assert "net" not in cell.config["loop"]
    assert "comp_cadence" not in cell.config["loop"]
    assert cell.net_path() is None
