"""Parity of the port's Engine with the JAX Engine at the slice's settings.

``Engine(ecfg)`` builds the same world bit for bit, and three
``Engine.step`` frames (split-dispatch GI: update_gi -> base frame ->
gi_composite) from the same pose under a panning mouse match the JAX
Engine's frames at >= 50 dB with the same GI words.  The wall clock that
animates the water is pinned in both.  Also: ``chip_smoke.py`` refuses to
run where there is no GPU.  The JAX side runs without FMA contraction
(tests/torch_jaxref.py).
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.ops import superstep_kernel
from rvgrt_tpu_torch.scene.camera import InputState
from tests import torch_jaxref as ref

SPEC = ref.SLICE_SPEC
STEPS = 3
POSE = dict(position=[30.0, 44.0, 60.0], yaw=math.pi + 0.25,
            pitch=-math.pi - 0.18, mouse_dx=2.0)
CLOCK = 1000.0


@pytest.fixture(scope="module")
def frames():
    want = ref.run([("ref_engine", dict(spec=SPEC, steps=STEPS, pose=POSE,
                                        clock=CLOCK))])[0]
    real_time = time.time
    time.time = lambda: CLOCK
    try:
        eng = engine.Engine(
            ref.make_ecfg(tcfg, ref.with_render(SPEC,
                                                fused_superstep=True)),
            verbose=False, device="cpu")
        eng.character.position = np.asarray(POSE["position"], np.float32)
        eng.character.yaw = POSE["yaw"]
        eng.character.pitch = POSE["pitch"]
        world = engine.world_to_numpy(eng.world)
        got = [eng.step(InputState(mouse_dx=POSE["mouse_dx"]))
               for _ in range(STEPS)]
    finally:
        time.time = real_time
    return dict(want=want, world=world, got=got, eng=eng)


def test_engine_world_bit_exact(frames):
    for k, v in frames["want"]["world"].items():
        np.testing.assert_array_equal(frames["world"][k], v, err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_engine_step_frames_50db(frames, step):
    got = frames["got"][step]
    want = frames["want"]["frames"][step]
    assert got.color.shape == (80, 128, 3)
    for f in ("color", "motion", "depth"):
        g = getattr(got, f).numpy()
        w = want[f]
        assert np.isfinite(g).all(), f
        scale = max(float(np.abs(w).max()), 1.0)
        assert ref.psnr(g / scale, w / scale) >= 50.0, f
    # same hit classification: misses carry depth exactly 1
    np.testing.assert_array_equal(got.depth.numpy() == 1.0,
                                  want["depth"] == 1.0)


def test_engine_gi_words_after_steps(frames):
    eng = frames["eng"]
    assert eng.frame_count == STEPS
    np.testing.assert_array_equal(u32.to_numpy(eng.world.gi),
                                  frames["want"]["gi"])


def test_engine_frames_move_with_the_camera(frames):
    a, b = frames["got"][0].color, frames["got"][-1].color
    assert float((a - b).abs().mean()) > 1e-3
    assert float(frames["got"][-1].motion.abs().max()) > 0.0


def test_cpu_run_launches_no_kernel(frames):
    """On CPU tensors the fused superstep is the plain version."""
    assert superstep_kernel.launches == 0


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """No result without a GPU, and none from a copy of the script that
    stands alone in a directory (nothing of the port beside it)."""
    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("a GPU is present")
    script = ref.REPO / "chip_smoke.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if where == "alone":
        alone = tmp_path / "alone"
        alone.mkdir()
        shutil.copy(script, alone / "chip_smoke.py")
        script = alone / "chip_smoke.py"
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
