"""The port's interactive viewer (``align3d_torch/viz/interactive.py``) on
the CPU, driven headlessly over HTTP as ``tests/test_interactive_viewer.py``
drives the JAX package's: WASD flight, drag orbit, number-key toggles and
quit; the controller's steps bitwise the JAX one's; every frame served
equal to a direct render of the same camera."""

import json
import urllib.request

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.viz import interactive as jinteractive
from align3d_tpu.viz import virtual_camera as jcam

from align3d_torch.io import png
from align3d_torch.viz import virtual_camera as cam
from align3d_torch.viz.interactive import InteractiveViewer, WASDCameraController
from align3d_torch.viz.viewers import GeoViewer

CPU = torch.device("cpu")


def _make_viewer():
    rng = np.random.default_rng(0)
    gv = GeoViewer(width=160, height=120, device=CPU)
    gv.add(rng.normal(0.0, 0.3, (500, 3)).astype(np.float32))
    gv.add(rng.normal(1.5, 0.3, (500, 3)).astype(np.float32))
    return InteractiveViewer(gv.scene, 160, 120, device=CPU)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _post(port, event):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/event",
        data=json.dumps(event).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


@pytest.fixture()
def served():
    viewer = _make_viewer()
    port = viewer.start(port=0)
    yield viewer, port
    viewer.stop()


def _direct(viewer) -> np.ndarray:
    return viewer.scene.render(viewer.renderer, viewer.controller.camera).color.numpy()


def test_page_and_frame(served):
    viewer, port = served
    page = _get(port, "/")
    assert b"WASD" in page
    frame = _get(port, "/frame.png")
    assert frame[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(png.decode(frame), _direct(viewer))


def test_wasd_moves_camera(served):
    viewer, port = served
    s0 = json.loads(_get(port, "/state"))
    _post(port, {"type": "key", "key": "w"})
    s1 = json.loads(_get(port, "/state"))
    # W flies along the view ray by velocity * radius * 2
    # (virtual_camera_controller.rs:58-63).
    eye0, eye1 = np.asarray(s0["eye"]), np.asarray(s1["eye"])
    step = np.linalg.norm(eye1 - eye0)
    expected = viewer.controller.velocity * viewer.controller.world_radius * 2
    assert step == pytest.approx(expected, rel=1e-5)
    assert np.allclose(s0["view"], s1["view"])  # W translates, no rotation
    assert np.array_equal(png.decode(_get(port, "/frame.png")), _direct(viewer))
    _post(port, {"type": "key", "key": "s"})
    s2 = json.loads(_get(port, "/state"))
    assert np.allclose(s2["eye"], s0["eye"], atol=1e-5)  # S undoes W
    _post(port, {"type": "key", "key": "d"})
    s3 = json.loads(_get(port, "/state"))
    assert not np.allclose(s3["eye"], s2["eye"])  # D strafes right


def test_drag_orbits(served):
    viewer, port = served
    s0 = json.loads(_get(port, "/state"))
    _post(port, {"type": "drag", "dx": 40, "dy": 0})
    s1 = json.loads(_get(port, "/state"))
    v0, v1 = np.asarray(s0["view"]), np.asarray(s1["view"])
    assert not np.allclose(v0, v1)  # horizontal drag rotates about up
    assert np.linalg.norm(v1) == pytest.approx(1.0, abs=1e-5)
    assert np.allclose(s0["eye"], s1["eye"])  # orbit rotates view, not eye
    assert np.array_equal(png.decode(_get(port, "/frame.png")), _direct(viewer))


def test_number_keys_toggle_visibility_and_change_frame(served):
    viewer, port = served
    f0 = _get(port, "/frame.png")
    _post(port, {"type": "key", "key": "2"})
    s = json.loads(_get(port, "/state"))
    assert s["visible"] == [True, False]
    f1 = _get(port, "/frame.png")
    assert f0 != f1  # hiding a geometry changes the rendered frame
    assert np.array_equal(png.decode(f1), _direct(viewer))
    _post(port, {"type": "key", "key": "2"})
    s = json.loads(_get(port, "/state"))
    assert s["visible"] == [True, True]


def test_quit_event(served):
    viewer, port = served
    assert not viewer.quit_requested.is_set()
    _post(port, {"type": "quit"})
    assert viewer.quit_requested.wait(timeout=5)


def test_bad_event_and_unknown_path(served):
    _, port = served
    req = urllib.request.Request(f"http://127.0.0.1:{port}/event", data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError, match="400"):
        urllib.request.urlopen(req, timeout=10)
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _get(port, "/nothing")


def test_controller_steps_bitwise_jax():
    """The same keys and drags on both packages' controllers leave the same
    camera bits (virtual_camera_controller.rs semantics)."""
    cams = [mod.VirtualCamera(eye=np.array([0.0, 0.0, 5.0], np.float32), view=np.array([0.0, 0.0, -1.0], np.float32),
                              up=np.array([0.0, 1.0, 0.0], np.float32)) for mod in (jcam, cam)]
    ours = WASDCameraController(cams[1], world_radius=2.0, viewport_width=640)
    theirs = jinteractive.WASDCameraController(cams[0], world_radius=2.0, viewport_width=640)
    rng = np.random.default_rng(1)
    for _ in range(40):
        if rng.uniform() < 0.5:
            key = "wasdx"[int(rng.integers(0, 5))]
            assert ours.key(key) == theirs.key(key)
        else:
            dx, dy = (float(v) for v in rng.normal(0, 30, 2))
            ours.drag(dx, dy)
            theirs.drag(dx, dy)
        for name in ("eye", "view", "up"):
            a, b = np.asarray(getattr(ours.camera, name)), np.asarray(getattr(theirs.camera, name))
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    np.testing.assert_allclose(np.linalg.norm(ours.camera.view), 1.0, atol=1e-6)
