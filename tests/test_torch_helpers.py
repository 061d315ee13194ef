"""The port's PNG atlas, profiling helpers, viewer and small helpers
against the JAX package's, on the CPU.

``world/atlas.py::load_png`` (zlib + struct, no Pillow) equals the JAX
``load_png`` (Pillow) on 256x256 PNGs that this file writes itself, RGB and
RGBA, with each of the five row filters and with the filters mixed row by
row; ``default_atlas`` takes ``REFERENCE_PNG`` when it exists in both
packages and falls back to the procedural atlas on a file it cannot load.
``MetricsLog``'s JSONL reads back in both packages; ``phase`` logs to it;
``device_time_ms`` without a GPU reports no device time.  The viewer
passes ``tests/test_subsystems.py``'s stub-engine round trip, its JPEGs
from the native encoder.  ``orbit_path``, ``is_solid_density`` and
``clamp01`` equal JAX's.  JAX runs in this process: nothing here is
compiled arithmetic that FMA contraction could change.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
import threading
import time
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from rvgrt_tpu.core import terrain as jterrain
from rvgrt_tpu.core import vecmath as jvm
from rvgrt_tpu.scene import camera as jcamera
from rvgrt_tpu.utils import profiling as jprof
from rvgrt_tpu.world import atlas as jatlas
from rvgrt_tpu_torch.core import terrain, u32
from rvgrt_tpu_torch.core import vecmath as vm
from rvgrt_tpu_torch.scene import camera
from rvgrt_tpu_torch.utils import profiling
from rvgrt_tpu_torch.world import atlas

FILTERS = ("none", "sub", "up", "average", "paeth", "mixed")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, img: np.ndarray, filters) -> None:
    """An 8-bit RGB or RGBA PNG of ``img`` (H, W, 3|4), row y filtered with
    ``filters(y)`` (0-4), in three IDAT chunks."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        f = filters(y)
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, ul)][f]
        raw.append(f)
        raw += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
    data = zlib.compress(bytes(raw), 6)
    cuts = [0, len(data) // 3, 2 * len(data) // 3, len(data)]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0))
    for a, b in zip(cuts, cuts[1:]):
        out += chunk(b"IDAT", data[a:b])
    with open(path, "wb") as f:
        f.write(out + chunk(b"IEND", b""))


def _image(chans: int, size: int = 256) -> np.ndarray:
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([xx, yy, (xx ^ yy)] + [xx + yy] * (chans - 3), -1)
    noise = rng.integers(0, 40, (size, size, chans))
    return ((base + noise) & 0xFF).astype(np.uint8)


def _filter(name):
    if name == "mixed":
        return lambda y: y % 5
    return lambda y: FILTERS.index(name)


@pytest.mark.parametrize("chans", [3, 4], ids=["rgb", "rgba"])
@pytest.mark.parametrize("name", FILTERS)
def test_load_png_equals_jax(tmp_path, name, chans):
    img = _image(chans)
    path = str(tmp_path / "pack.png")
    write_png(path, img, _filter(name))
    np.testing.assert_array_equal(atlas.decode_png(open(path, "rb").read()),
                                  img)
    got = u32.to_numpy(atlas.load_png(path, device="cpu"))
    want = np.asarray(jatlas.load_png(path))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["pack", "wrong_size", "absent"])
def test_default_atlas_prefers_reference_png(tmp_path, monkeypatch, kind):
    path = str(tmp_path / "texturepack.png")
    if kind == "pack":
        write_png(path, _image(4), _filter("mixed"))
    elif kind == "wrong_size":
        write_png(path, _image(3, 128), _filter("none"))
    monkeypatch.setattr(atlas, "REFERENCE_PNG", path)
    monkeypatch.setattr(jatlas, "REFERENCE_PNG", path)
    got = u32.to_numpy(atlas.default_atlas(device="cpu"))
    np.testing.assert_array_equal(got, np.asarray(jatlas.default_atlas()))
    proc = u32.to_numpy(atlas.procedural_atlas(device="cpu"))
    assert (got == proc).all() == (kind != "pack")


@pytest.mark.parametrize("ctype,depth", [(0, 8), (3, 8), (2, 16), (4, 8)])
def test_decode_png_refuses_other_types(ctype, depth):
    body = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(body)) + b"IHDR"
            + body + b"\0\0\0\0")
    with pytest.raises(ValueError, match="unsupported PNG"):
        atlas.decode_png(data)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_metrics_log_round_trip(tmp_path, writer):
    path = str(tmp_path / "m" / "metrics.jsonl")
    logs = (profiling.MetricsLog(path), jprof.MetricsLog(path))
    w, r = logs if writer == "port" else logs[::-1]
    assert r.read() == []
    w.log(event="frame", ms=12.5)
    w.log(event="frame", ms=13.5, ts=7.0)
    with profiling.phase("build", sink=w, verbose=False):
        pass
    rows = r.read()
    assert rows == logs[0].read() == logs[1].read()
    assert [x["event"] for x in rows] == ["frame", "frame", "phase"]
    assert rows[0]["ms"] == 12.5 and rows[1]["ts"] == 7.0
    assert rows[2]["name"] == "build" and rows[2]["ms"] >= 0.0
    assert all(set(x) >= {"event", "ts"} for x in rows)


def test_device_time_ms_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    calls = []
    ms, ops = profiling.device_time_ms(lambda x: calls.append(x) or x * 2,
                                       torch.ones(4), warmup=2)
    assert len(calls) == 3
    assert math.isnan(ms) and ops == {}


def test_viewer_serves_frames_and_inputs():
    """Live viewer round trip with a stub engine: page, frame, stream,
    stats, and input POST reach the render loop
    (``tests/test_subsystems.py::test_viewer_serves_frames_and_inputs``);
    the frames are torch tensors here."""
    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig
    from rvgrt_tpu_torch.driver.viewer import ViewerServer

    class StubOut:
        def __init__(self, v):
            self.color = torch.full((24, 32, 3), v)

    class StubEngine:
        def __init__(self):
            self.ecfg = EngineConfig(render=dataclasses.replace(
                RenderConfig(), width=32, height=24))
            self.seen = []

        def step(self, inputs, dt):
            self.seen.append(inputs)
            return StubOut(0.5)

    eng = StubEngine()
    srv = ViewerServer(eng, port=0, max_fps=120).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"rvgrt_tpu viewer" in page
        jpg = urllib.request.urlopen(base + "/frame.jpg", timeout=10).read()
        assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
        with urllib.request.urlopen(base + "/stream", timeout=10) as s:
            assert s.headers["Content-Type"].startswith(
                "multipart/x-mixed-replace")
            head = s.read(64)
            assert head.startswith(b"--f\r\nContent-Type: image/jpeg")
        req = urllib.request.Request(
            base + "/input",
            data=json.dumps({"move_z": 1, "mouse_dx": 3.5}).encode(),
            method="POST")
        assert urllib.request.urlopen(req, timeout=10).status == 204
        stats = json.loads(urllib.request.urlopen(
            base + "/stats", timeout=10).read())
        assert stats["frames"] >= 1
        deadline = time.time() + 5
        while time.time() < deadline:
            if any(i.move_z == 1.0 for i in eng.seen):
                break
            time.sleep(0.02)
        assert any(i.move_z == 1.0 for i in eng.seen)
        assert sum(i.mouse_dx for i in eng.seen) <= 3.5 + 1e-6
    finally:
        srv.stop()


def test_viewer_render_failure_ends_streams_and_raises():
    """A step that raises stops the render loop: the open stream ends after
    the one frame that was rendered (no stale part is sent again), and
    ``stop()`` raises the step's error."""
    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig
    from rvgrt_tpu_torch.driver.viewer import ViewerServer

    class StubOut:
        color = torch.full((24, 32, 3), 0.25)

    class FailingEngine:
        ecfg = EngineConfig(render=dataclasses.replace(
            RenderConfig(), width=32, height=24))

        def __init__(self):
            self.steps = 0
            self.go = threading.Event()

        def step(self, inputs, dt):
            self.steps += 1
            if self.steps > 1:
                self.go.wait(10)
                raise ValueError("step failed")
            return StubOut()

    eng = FailingEngine()
    srv = ViewerServer(eng, port=0, max_fps=120).start()
    stopped = False
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/stream", timeout=10) as s:
            eng.go.set()
            body = s.read()  # returns once the server ends the stream
        assert body.count(b"--f\r\n") == 1
        srv.wait()
        stopped = True
        with pytest.raises(RuntimeError, match="render loop failed") as e:
            srv.stop()
        assert isinstance(e.value.__cause__, ValueError)
        assert eng.steps == 2
    finally:
        if not stopped:
            eng.go.set()
            with pytest.raises(RuntimeError):
                srv.stop()


def test_viewer_stream_sends_the_last_frame_after_a_failure():
    """The interleaving in which a stream lost its last frame, forced: the
    stream handler is held back after its headers until the render loop
    has failed (its second step raises), then let go.  The stream still
    sends the one frame that was published and then ends; ``stop()``
    raises the step's error."""
    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig
    from rvgrt_tpu_torch.driver.viewer import ViewerServer

    class StubOut:
        color = torch.full((24, 32, 3), 0.5)

    class FailingEngine:
        ecfg = EngineConfig(render=dataclasses.replace(
            RenderConfig(), width=32, height=24))

        def __init__(self):
            self.steps = 0
            self.go = threading.Event()

        def step(self, inputs, dt):
            self.steps += 1
            if self.steps > 1:
                self.go.wait(10)
                raise ValueError("step failed")
            return StubOut()

    eng = FailingEngine()
    srv = ViewerServer(eng, port=0, max_fps=120)
    handler = srv.httpd.RequestHandlerClass
    end_headers = handler.end_headers
    held = []

    def end_headers_then_hold(self):
        end_headers(self)
        if self.path == "/stream":
            held.append(srv._stop.wait(10))

    handler.end_headers = end_headers_then_hold
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/stream", timeout=10) as s:
            eng.go.set()
            body = s.read()
        assert held == [True]
        assert body.count(b"--f\r\n") == 1
        assert body.rstrip().endswith(b"\xff\xd9")
    finally:
        eng.go.set()
        with pytest.raises(RuntimeError, match="render loop failed") as e:
            srv.stop()
    assert isinstance(e.value.__cause__, ValueError)
    assert eng.steps == 2


def test_viewer_stream_waits_for_the_first_frame():
    """A stream opened before the first frame waits for it without
    spinning: a handful of waits, not one per turn of a busy loop, and the
    frame is sent once."""
    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig
    from rvgrt_tpu_torch.driver.viewer import ViewerServer

    class StubOut:
        color = torch.full((24, 32, 3), 0.75)

    class SlowEngine:
        ecfg = EngineConfig(render=dataclasses.replace(
            RenderConfig(), width=32, height=24))

        def __init__(self):
            self.first = threading.Event()

        def step(self, inputs, dt):
            self.first.wait(10)
            return StubOut()

    eng = SlowEngine()
    srv = ViewerServer(eng, port=0, max_fps=2)
    waits = []
    wait_after = srv._wait_frame_after

    def counted(seq):
        waits.append(seq)
        return wait_after(seq)

    srv._wait_frame_after = counted
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/stream", timeout=10) as s:
            time.sleep(0.5)  # the stream waits while no frame exists
            eng.first.set()
            head = s.read(64)
        assert head.startswith(b"--f\r\nContent-Type: image/jpeg")
        assert waits[0] == 0 and len(waits) <= 3, waits[:10]
    finally:
        eng.first.set()
        srv.stop()


def test_orbit_path_equals_jax():
    center = np.array([32.0, 40.0, 32.0], np.float32)
    target = np.array([30.0, 20.0, 34.0], np.float32)
    got = camera.orbit_path(7, center, 12.5, 44.0, target)
    want = jcamera.orbit_path(7, center, 12.5, 44.0, target)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        for f in ("pos", "forward", "right", "up"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_is_solid_density_equals_jax():
    rng = np.random.default_rng(5)
    p = [rng.uniform(0.0, 256.0, 4096).astype(np.float32) for _ in range(3)]
    p[1] = rng.uniform(20.0, 120.0, 4096).astype(np.float32)
    got = terrain.is_solid_density(*(torch.from_numpy(a) for a in p))
    want = np.asarray(jterrain.is_solid_density(*p))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_clamp01_equals_jax():
    rng = np.random.default_rng(6)
    a = [rng.uniform(-2.0, 2.0, 64).astype(np.float32) for _ in range(3)]
    got = vm.clamp01(tuple(torch.from_numpy(x) for x in a))
    want = jvm.clamp01(tuple(a))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
