"""Interactive viewer (port of ``align3d_tpu/viz/interactive.py``) — the
runtime equivalent of the reference's windowed event loop
(``src/viz/window.rs:145-385``), built as a zero-dependency localhost web
app over :class:`OffscreenRenderer` on ``device`` (the card unless the
caller asks for the CPU) instead of a Vulkan swapchain.

Controls mirror the reference exactly:

* **W/A/S/D** — fly camera: forward/back along the view ray, strafe
  left/right, step = ``velocity * world_radius * 2``
  (``controllers/virtual_camera_controller.rs:56-77``, velocity 0.25).
* **Left-drag** — orbit: horizontal drag rotates about the up axis,
  vertical drag about the right axis, scaled by
  ``viewport_width * sensitivity`` (``virtual_camera_controller.rs:79-91``,
  sensitivity 0.1).
* **1..9** — toggle visibility of the nth geometry
  (``geoviewer.rs:50-67``).
* **Q / Esc** — quit the event loop (``window.rs`` close handling).

The server side is plain ``http.server``; the page is a single <img> that
re-fetches ``/frame.png`` after every input event. Everything is drivable
headlessly over HTTP, which is how the CI test exercises the full event
loop without a display. The handler threads share one device context: one
lock guards the scene, the camera and every render; a frame leaves the
device once, as its colour, for the PNG encoder (:mod:`align3d_torch.io.png`).
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from align3d_torch.io import png
from align3d_torch.viz.render import OffscreenRenderer
from align3d_torch.viz.scene import Scene
from align3d_torch.viz.virtual_camera import (
    VirtualCamera,
    VirtualCameraSphericalBuilder,
)

_PAGE = """<!doctype html>
<html><head><title>align3d_torch viewer</title><style>
body { margin: 0; background: #111; color: #ccc; font: 13px monospace; }
#bar { padding: 4px 8px; }
img { display: block; image-rendering: pixelated; }
</style></head><body>
<div id="bar">align3d_torch &mdash; WASD fly &middot; drag orbit &middot;
1..9 toggle geometry &middot; Q quit</div>
<img id="view" src="/frame.png" draggable="false">
<script>
const img = document.getElementById('view');
let gen = 0;
function refresh() { gen += 1; img.src = '/frame.png?g=' + gen; }
async function send(ev) {
  await fetch('/event', {method: 'POST', body: JSON.stringify(ev)});
  refresh();
}
document.addEventListener('keydown', (e) => {
  const k = e.key.toLowerCase();
  if (k === 'q' || k === 'escape') { send({type: 'quit'}); return; }
  send({type: 'key', key: k});
});
let dragging = false, lx = 0, ly = 0;
img.addEventListener('mousedown', (e) => { dragging = true; lx = e.clientX; ly = e.clientY; });
document.addEventListener('mouseup', () => { dragging = false; });
document.addEventListener('mousemove', (e) => {
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  send({type: 'drag', dx: dx, dy: dy});
});
</script></body></html>"""


class WASDCameraController:
    """Keyboard/mouse camera control (virtual_camera_controller.rs:21-98)."""

    def __init__(
        self,
        camera: VirtualCamera,
        world_radius: float,
        velocity: float = 0.25,
        rotation_sensitivity: tuple[float, float] = (0.1, 0.1),
        viewport_width: int = 640,
    ):
        self.camera = camera
        self.world_radius = float(world_radius)
        self.velocity = float(velocity)
        self.rotation_sensitivity = rotation_sensitivity
        self.viewport_width = int(viewport_width)

    def key(self, key: str) -> bool:
        """Apply one WASD key; returns True if the camera moved."""
        step = self.velocity * self.world_radius * 2.0
        if key == "w":
            self.camera.translate_eye(step)
        elif key == "s":
            self.camera.translate_eye(-step)
        elif key == "a":
            self.camera.translate_right(-step)
        elif key == "d":
            self.camera.translate_right(step)
        else:
            return False
        return True

    def drag(self, dx: float, dy: float) -> None:
        """Left-drag orbit; the reference divides the cursor delta by
        viewport_width * sensitivity for BOTH axes
        (virtual_camera_controller.rs:82-88, difference = last - current)."""
        ddx = -float(dx) / (self.viewport_width * self.rotation_sensitivity[0])
        ddy = -float(dy) / (self.viewport_width * self.rotation_sensitivity[1])
        self.camera.rotate_right_axis(-ddy)
        self.camera.rotate_up_axis(ddx)


class InteractiveViewer:
    """Event loop + swapchain stand-in: render-on-demand over HTTP."""

    def __init__(
        self,
        scene: Scene,
        width: int = 640,
        height: int = 480,
        velocity: float = 0.25,
        device="cuda",
    ):
        self.scene = scene
        self.renderer = OffscreenRenderer(width, height, device=device)
        sphere = scene.bounding_sphere()
        builder = VirtualCameraSphericalBuilder.fit(sphere, math.pi / 2.0)
        builder.aspect_ratio = width / height
        self.controller = WASDCameraController(
            builder.build(),
            world_radius=float(sphere.radius),
            velocity=velocity,
            viewport_width=width,
        )
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.quit_requested = threading.Event()

    # -- event handling (window.rs:229-309 dispatch) ----------------------
    def handle_event(self, event: dict) -> None:
        with self._lock:
            etype = event.get("type")
            if etype == "key":
                key = str(event.get("key", ""))
                if key.isdigit() and key != "0":
                    idx = int(key) - 1
                    if idx < len(self.scene.nodes):
                        node = self.scene.nodes[idx]
                        node.visible = not node.visible
                else:
                    self.controller.key(key)
            elif etype == "drag":
                self.controller.drag(
                    float(event.get("dx", 0.0)), float(event.get("dy", 0.0))
                )
            elif etype == "quit":
                self.quit_requested.set()

    def render_png(self) -> bytes:
        with self._lock:
            color = self.scene.render(self.renderer, self.controller.camera).color.cpu().numpy()
        return png.encode(color)

    def state(self) -> dict:
        with self._lock:
            cam = self.controller.camera
            return {
                "eye": [float(x) for x in cam.eye],
                "view": [float(x) for x in cam.view],
                "visible": [bool(n.visible) for n in self.scene.nodes],
            }

    # -- server -----------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start serving in a background thread; returns the bound port."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/frame.png":
                    self._send(200, viewer.render_png(), "image/png")
                elif path == "/state":
                    self._send(
                        200, json.dumps(viewer.state()).encode(),
                        "application/json",
                    )
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path.split("?")[0] != "/event":
                    self._send(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    event = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, b"bad event", "text/plain")
                    return
                viewer.handle_event(event)
                self._send(200, b"ok", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return int(self._server.server_address[1])

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def run(self, host: str = "127.0.0.1", port: int = 8700) -> None:
        """Blocking event loop: serve until the page sends quit (Q/Esc)."""
        bound = self.start(host, port)
        print(
            f"interactive viewer at http://{host}:{bound}/ "
            "(WASD fly, drag orbit, 1..9 toggle, Q quit)",
            flush=True,
        )
        try:
            self.quit_requested.wait()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def show_scene(scene: Scene, width: int = 640, height: int = 480, port: int = 8700, device="cuda"):
    InteractiveViewer(scene, width, height, device=device).run(port=port)
