"""Interactive live viewer: an HTTP server, an MJPEG stream and a page.

The port of ``rvgrt_tpu/driver/viewer.py``.  The reference's L7/L6 is a
Win32 window with raw-mouse + WASD input and a D3D12 swap chain
(``main.cpp:555-674``, ``renderLoop`` ``main.cpp:104-234``).  On a
headless GPU host the equivalent is a tiny HTTP server + browser page:

* the render loop runs in a background thread, stepping the engine with the
  latest input snapshot (the ``InputState`` dataclass replaces key polling);
  if a step or the encoder raises, the loop stops, every stream ends and
  ``stop()`` raises that error, so a failed render is never shown as a
  frozen frame;
* "present" is an MJPEG stream (multipart/x-mixed-replace) - each part is
  one frame, quantised on the device, brought to the host and encoded as
  JPEG by the native encoder (``native/videosink.cpp``'s
  ``videosink_write_jpeg``, built with g++ on first use);
* the page captures WASD / space / shift and pointer-lock mouse deltas and
  POSTs them as JSON (the raw-input registration analogue,
  ``main.cpp:651-656``); Escape releases the pointer like the reference's
  Escape-quit (``WndProc``, ``main.cpp:560``).

The server uses the stdlib only, and an ``engine`` object exposing
``ecfg``, ``step(InputState, dt) -> FrameOutputs`` and, for ``main``, a
``character``: the port's ``Engine``, or a stub in tests.

    python -m rvgrt_tpu_torch.driver.viewer --config tiny [--device cpu]
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from rvgrt_tpu_torch.scene.camera import InputState

_PAGE = """<!doctype html>
<title>rvgrt_tpu viewer</title>
<style>
 body { margin:0; background:#111; color:#9ab; font:13px monospace }
 #hud { position:fixed; top:8px; left:8px; }
 img  { display:block; margin:0 auto; image-rendering:pixelated;
        width:min(100vw, 100vh * %ASPECT%); }
</style>
<img id=v src="/stream">
<div id=hud>click to fly &mdash; WASD + mouse, space up, shift down,
Esc releases</div>
<script>
const keys = {};
let mdx = 0, mdy = 0;
const v = document.getElementById('v');
v.onclick = () => v.requestPointerLock();
document.addEventListener('keydown', e => { keys[e.code] = 1; });
document.addEventListener('keyup',   e => { keys[e.code] = 0; });
document.addEventListener('mousemove', e => {
  if (document.pointerLockElement === v) { mdx += e.movementX; mdy += e.movementY; }
});
setInterval(() => {
  const body = JSON.stringify({
    move_x: (keys['KeyD']?1:0) - (keys['KeyA']?1:0),
    move_y: (keys['ShiftLeft']?1:0) - (keys['Space']?1:0),
    move_z: (keys['KeyW']?1:0) - (keys['KeyS']?1:0),
    mouse_dx: mdx, mouse_dy: mdy,
  });
  mdx = 0; mdy = 0;
  fetch('/input', {method: 'POST', body});
}, 33);
</script>
"""


def _encode_jpeg(img_u8: np.ndarray, quality: int = 88) -> bytes:
    """(H, W, 3) uint8 -> JPEG bytes through the native encoder, which
    writes a file: a temporary one, read back and removed."""
    from rvgrt_tpu_torch.driver import native, videosink

    a = native.rgb_frame(img_u8)
    h, w, _ = a.shape
    fd, path = tempfile.mkstemp(suffix=".jpg")
    os.close(fd)
    try:
        err = videosink.get_lib().videosink_write_jpeg(
            path.encode(), a.ctypes.data_as(native.U8P), w, h, quality)
        if err != 0:
            raise RuntimeError(f"JPEG encoder failed ({err})")
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.remove(path)


def _to_u8(color) -> np.ndarray:
    """[0, 1] colour (a tensor on any device, or a host array) -> host (H,
    W, 3) uint8, quantised (truncating) where the colour lies."""
    from rvgrt_tpu_torch.driver.cli import to_u8

    return to_u8(torch.as_tensor(color)).cpu().numpy()


class ViewerServer:
    """Live viewer around any engine-like object.

    ``engine.step(inputs, dt)`` must return an object with a ``color``
    (H, W, 3) float tensor or array in [0, 1] (on any device).  The render loop is
    paced by the engine itself (one step per loop turn); clients only ever
    see the latest completed frame.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 max_fps: float = 60.0):
        self.engine = engine
        self._inputs = InputState()
        self._lock = threading.Lock()
        self._frame_jpeg: bytes | None = None
        self._frame_seq = 0
        self._frame_cv = threading.Condition()
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._min_dt = 1.0 / max_fps
        self.frame_count = 0
        self.last_frame_ms = 0.0

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    h, w = viewer._shape()
                    page = _PAGE.replace("%ASPECT%", f"{w / h:.5f}")
                    body = page.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame.jpg":
                    data = viewer._wait_frame()
                    if not data:  # no frame yet (e.g. first-frame compile)
                        self.send_error(503, "no frame rendered yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=f")
                    self.end_headers()
                    last = 0  # the first frame published is number 1
                    try:
                        while True:
                            # a frame newer than the last one sent goes out
                            # before the stop is looked at, so a stream
                            # ends after every frame that was published
                            data, seq = viewer._wait_frame_after(last)
                            if seq == last or not data:
                                # no new frame (a long first frame, or a
                                # timed-out wait): keep the stream open and
                                # send neither an empty part (browsers drop
                                # the stream) nor the last one again
                                if viewer._stop.is_set():
                                    break
                                continue
                            last = seq
                            self.wfile.write(
                                b"--f\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(data)}\r\n\r\n"
                                .encode())
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/stats":
                    body = json.dumps(dict(
                        frames=viewer.frame_count,
                        frame_ms=round(viewer.last_frame_ms, 2))).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path == "/input":
                    n = int(self.headers.get("Content-Length", 0))
                    d = json.loads(self.rfile.read(n) or b"{}")
                    with viewer._lock:
                        # mouse deltas ACCUMULATE across posts (the render
                        # loop zeroes them on consume); frames take seconds
                        # on big configs while input posts at ~30 Hz -
                        # overwriting would drop most look motion
                        prev = viewer._inputs
                        viewer._inputs = InputState(
                            move_x=float(d.get("move_x", 0)),
                            move_y=float(d.get("move_y", 0)),
                            move_z=float(d.get("move_z", 0)),
                            mouse_dx=prev.mouse_dx + float(d.get("mouse_dx", 0)),
                            mouse_dy=prev.mouse_dy + float(d.get("mouse_dy", 0)))
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_error(404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._threads: list[threading.Thread] = []

    # -- frame plumbing -------------------------------------------------
    def _shape(self):
        r = self.engine.ecfg.render
        return r.height, r.width

    def _publish(self, jpeg: bytes):
        with self._frame_cv:
            self._frame_jpeg = jpeg
            self._frame_seq += 1
            self._frame_cv.notify_all()

    def _wait_frame(self) -> bytes:
        with self._frame_cv:
            self._frame_cv.wait_for(
                lambda: self._frame_jpeg is not None or self._stop.is_set(),
                timeout=60)
            return self._frame_jpeg or b""

    def _wait_frame_after(self, seq: int):
        with self._frame_cv:
            self._frame_cv.wait_for(
                lambda: self._frame_seq != seq or self._stop.is_set(),
                timeout=60)
            return self._frame_jpeg or b"", self._frame_seq

    def _render_loop(self):
        try:
            self._render_frames()
        except BaseException as e:  # stop serving; stop() raises it
            self._error = e
            self._stop.set()
            with self._frame_cv:
                self._frame_cv.notify_all()

    def _render_frames(self):
        while not self._stop.is_set():
            t0 = time.time()
            with self._lock:
                inputs = self._inputs
                # mouse deltas are consumed once per frame
                self._inputs = InputState(move_x=inputs.move_x,
                                          move_y=inputs.move_y,
                                          move_z=inputs.move_z)
            out = self.engine.step(inputs, max(self.last_frame_ms / 1e3,
                                               1 / 60))
            self._publish(_encode_jpeg(_to_u8(out.color)))
            self.frame_count += 1
            dt = time.time() - t0
            self.last_frame_ms = dt * 1e3
            if dt < self._min_dt:
                time.sleep(self._min_dt - dt)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        for target in (self._render_loop, self.httpd.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def wait(self):
        """Block until the server stops (``stop()``, or a failed render)."""
        self._stop.wait()

    @property
    def running(self) -> bool:
        """False once the server was stopped or its render loop failed
        (then ``stop()`` raises the loop's error)."""
        return not self._stop.is_set()

    def stop(self, timeout: float = 60.0):
        """Stop serving, then wait for the render loop's frame in flight;
        raise the render loop's error if it failed."""
        self._stop.set()
        with self._frame_cv:
            self._frame_cv.notify_all()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(timeout)
        if self._error is not None:
            raise RuntimeError("the viewer's render loop failed") \
                from self._error


def main(argv=None):
    import argparse

    from rvgrt_tpu_torch.driver import cli as cli_mod
    from rvgrt_tpu_torch.driver.engine import Engine

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="tiny",
                   choices=list(cli_mod.CONFIGS) + ["tiny"])
    p.add_argument("--no-gi", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    ecfg = (cli_mod.tiny_config() if args.config == "tiny"
            else cli_mod.CONFIGS[args.config]())
    eng = Engine(ecfg, include_gi=not args.no_gi, device=args.device)
    cli_mod.spawn_above_terrain(eng)
    srv = ViewerServer(eng, host=args.host, port=args.port).start()
    print(f"viewer at http://{args.host}:{srv.port}/  (Ctrl-C to quit)")
    try:
        srv.wait()
    except KeyboardInterrupt:
        pass
    srv.stop()


if __name__ == "__main__":
    main()
