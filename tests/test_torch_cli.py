"""The port's headless driver (``rvgrt_tpu_torch/driver/cli.py``) against
the JAX package's (``rvgrt_tpu/driver/cli.py``), on the CPU.

``CONFIGS`` and ``tiny_config`` are field for field the JAX ones;
``find_interesting_column`` and ``spawn_above_terrain`` pick the same
column and pose from the same 64^3 bits; ``FrameTimeAverager`` gives the
same averages on a fixed clock.  ``cli.main(["--config", "tiny",
"--frames", "2", "--device", "cpu", "--out", dir])`` - the traced GI init,
two ``Engine.step`` frames, the native PNG sink built from
``native/framesink.cpp`` - writes two PNGs whose pixels are the engine's
frames quantised (decoded here with ``zlib``).  With ``--upscale fresh``
and ``--upscale checkpoints/upscaler_r2.pkl`` the PNGs are the learned
upscaler's 3x frames, each over the previous one as its history.  With
``--upscale temporal`` they are the accumulator's 3x frames with its
default ``bilinear_shift`` taps, as the JAX CLI runs it: the engine's
frames through JAX's ``temporal_upscale`` in a child process without FMA
contraction (``ref_temporal``) give the same PNGs.  Everything else JAX
does here is integer or host work, so it runs in this process.
"""

from __future__ import annotations

import dataclasses
import struct
import types
import zlib

import numpy as np
import pytest
import torch

from rvgrt_tpu.driver import cli as jcli
from rvgrt_tpu.scene.camera import Character as JCharacter
from rvgrt_tpu.utils import timer as jtimer
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import cli
from rvgrt_tpu_torch.driver.videosink import VideoSink
from rvgrt_tpu_torch.upscale import model as up_model
from rvgrt_tpu_torch.utils import timer
from tests import torch_jaxref as ref

FRAMES = 2


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG with filter 0 on every row (what
    the native sink writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all(), "a row filter other than 0"
    return rows[:, 1:].reshape(h, w, 3)


def _run_cli(out, *extra):
    """One CLI run at tiny on the CPU: its stats, its engine, and each
    frame that ``Engine.step`` returned with the jitter after it."""
    seen = {}
    real = cli.Engine

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["eng"] = self
            seen["frames"] = []
            seen["jitters"] = []

        def step(self, *a, **kw):
            res = super().step(*a, **kw)
            seen["frames"].append(res)
            seen["jitters"].append(self.character.ray_jitter_ndc())
            return res

    cli.Engine = Recording
    try:
        stats = cli.main(["--config", "tiny", "--frames", str(FRAMES),
                          "--device", "cpu", "--out", str(out), *extra])
    finally:
        cli.Engine = real
    return dict(seen, stats=stats, out=out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run_cli(tmp_path_factory.mktemp("frames"))


def test_configs_equal_jax():
    assert list(cli.CONFIGS) == list(jcli.CONFIGS)
    for name, make in cli.CONFIGS.items():
        assert dataclasses.asdict(make()) == dataclasses.asdict(
            jcli.CONFIGS[name]()), name
    assert dataclasses.asdict(cli.tiny_config()) == dataclasses.asdict(
        jcli.tiny_config())


def test_cli_writes_the_engines_frames_as_pngs(run):
    assert run["stats"]["written"] == FRAMES
    assert run["stats"]["dropped"] == 0
    assert len(run["frames"]) == FRAMES
    files = sorted(run["out"].glob("*.png"))
    assert [f.name for f in files] == [f"frame_{i:06d}.png"
                                       for i in range(FRAMES)]
    for f, out in zip(files, run["frames"]):
        want = (torch.clamp(out.color, 0, 1) * 255).to(torch.uint8).numpy()
        assert want.shape == (96, 160, 3)
        np.testing.assert_array_equal(read_png(f), want)
    # the tiny config's traced GI init ran (no heightfield words)
    assert run["eng"].ecfg.gi_init_mode == "traced"
    assert run["stats"]["phase_s"]["initializing GI"] > 0


def _jax_engine(bits: np.ndarray):
    return types.SimpleNamespace(
        ecfg=jcli.tiny_config(), world=types.SimpleNamespace(bits=bits),
        character=JCharacter())


@pytest.mark.parametrize("column", ["picked", "given"])
def test_spawn_equals_jax(run, column):
    eng = run["eng"]
    bits = u32.to_numpy(eng.world.bits)
    assert cli.find_interesting_column(eng) == \
        jcli.find_interesting_column(_jax_engine(bits))
    xz = {} if column == "picked" else dict(x=7, z=50)
    want_eng = _jax_engine(bits)
    want = jcli.spawn_above_terrain(want_eng, **xz)
    got = cli.spawn_above_terrain(eng, **xz)
    np.testing.assert_array_equal(got, want)
    assert (eng.character.yaw, eng.character.pitch) == (
        want_eng.character.yaw, want_eng.character.pitch)


@pytest.mark.parametrize("upscale", ["fresh", "checkpoints/upscaler_r2.pkl"])
def test_cli_runs_the_learned_upscaler(upscale, tmp_path):
    """``--upscale fresh|PATH`` writes the net's 3x frames, each upscaled
    over the previous output as its history."""
    got = _run_cli(tmp_path, "--upscale", str(ref.REPO / upscale)
                   if upscale != "fresh" else upscale)
    assert got["stats"]["written"] == FRAMES
    if upscale == "fresh":
        net = up_model.init_params(96, 160,
                                   generator=torch.Generator().manual_seed(0),
                                   device="cpu")
        assert float(net.shuffle.weight.detach().abs().max()) == 0.0
    else:
        net = up_model.load_checkpoint(str(ref.REPO / upscale), device="cpu")
        assert (net.features, net.depth_layers) == (32, 3)
    history = torch.zeros(288, 480, 3)
    files = sorted(tmp_path.glob("*.png"))
    assert len(files) == FRAMES
    for f, out, jit in zip(files, got["frames"], got["jitters"]):
        history, _ = up_model.upscale(net, out.color, out.motion, out.depth,
                                      torch.tensor(jit, dtype=torch.float32),
                                      history)
        want = cli.to_u8(history).numpy()
        assert want.shape == (288, 480, 3) and want.std() > 1.0
        np.testing.assert_array_equal(read_png(f), want)


def test_cli_temporal_equals_jax_accumulator(tmp_path):
    """``--upscale temporal`` writes the accumulator's 3x frames with the
    JAX CLI's taps (``bilinear_shift``, the accumulator's default): JAX's
    ``temporal_upscale`` on the engine's frames and jitters gives the same
    PNGs."""
    got = _run_cli(tmp_path, "--upscale", "temporal")
    assert got["stats"]["written"] == FRAMES
    frames = [dict(color=o.color.numpy(), motion=o.motion.numpy(),
                   depth=o.depth.numpy(), jitter=np.asarray(j, np.float32))
              for o, j in zip(got["frames"], got["jitters"])]
    want = ref.run([("ref_temporal", dict(frames=frames,
                                          taps="bilinear_shift"))])[0]
    files = sorted(tmp_path.glob("*.png"))
    assert len(files) == FRAMES
    for f, w in zip(files, want):
        exp = (np.clip(w, 0, 1) * 255).astype(np.uint8)
        assert exp.shape == (288, 480, 3) and exp.std() > 1.0
        np.testing.assert_array_equal(read_png(f), exp)


def test_frame_time_averager_equals_jax(monkeypatch):
    clock = iter(np.cumsum([0.5, 0.016, 0.02, 0.033, 0.017, 0.1] * 7))
    ticks = []
    monkeypatch.setattr("time.perf_counter", lambda: ticks[-1])
    got, want = timer.FrameTimeAverager(window=5), \
        jtimer.FrameTimeAverager(window=5)
    for t in clock:
        ticks.append(float(t))
        assert got.tick() == want.tick()
        assert (got.average_ms, got.fps) == (want.average_ms, want.fps)


def test_video_sink_writes_an_avi(tmp_path):
    path = str(tmp_path / "v.avi")
    frame = np.random.RandomState(0).randint(0, 256, (16, 24, 3), np.uint8)
    with VideoSink(path, 24, 16, fps=30.0) as sink:
        assert sink.push(torch.from_numpy(frame))
        assert sink.push(frame[::-1].copy())
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert data.count(b"\xff\xd8") >= 2  # two JPEG frames

