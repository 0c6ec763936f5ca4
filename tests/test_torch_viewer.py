"""The port's browser viewer (gaussian_ray_tracing_tpu_torch/viewer.py):
tests/test_viewer.py's three tests on the port's tracer (device cpu,
64x48), plus a fisheye mirror frame and a glass frame of an SH 3 scene,
each a PNG that differs from the same view without the mesh."""

import json
import urllib.request

import torch

from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import read_png
from gaussian_ray_tracing_tpu_torch.viewer import serve

torch.set_num_threads(1)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
CFG = RenderConfig(hit_multiplicity=1, order="key")


def _serve(n: int, seed: int, width=64, height=48, config=CFG):
    tracer = GaussianRayTracer(scene=random_scene(n, seed=seed), config=config, device="cpu")
    srv = serve(tracer, port=0, width=width, height=height, block=False)
    port = srv.server_address[1]
    get = lambda path: urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                              timeout=300).read()
    return srv, get


def _pixels(tmp_path, data: bytes):
    path = tmp_path / "frame.png"
    path.write_bytes(data)
    return read_png(str(path))


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def test_viewer_serves_frames():
    srv, get = _serve(1000, 0)
    try:
        assert b"gaussian-ray-tracing-tpu" in get("/")
        assert get("/frame?az=30&el=10&r=3")[:8] == PNG_MAGIC
        assert get("/frame?az=0&el=0&r=3&fisheye=1")[:8] == PNG_MAGIC
        get("/add?kind=plane")
        assert get("/frame?az=0&el=0&r=3&type=normal")[:8] == PNG_MAGIC
        get("/clear")
        assert b'"prims": 0' in get("/info")
    finally:
        _stop(srv)


def test_viewer_transform_edit_changes_render():
    """Gizmo parity (gui.cpp:374-438): translate / rotate / scale a
    primitive through /edit (update_instance_transform); the frame
    changes; /remove takes it out."""
    srv, get = _serve(800, 0)
    try:
        get("/add?kind=plane")
        base = get("/frame?az=0&el=0&r=3&type=normal")
        t0 = json.loads(get("/prims"))["prims"][0]["transform"]
        get("/edit?i=0&op=translate&dx=0.4")
        t1 = json.loads(get("/prims"))["prims"][0]["transform"]
        assert abs(t1[0][3] - (t0[0][3] + 0.4)) < 1e-5
        assert get("/frame?az=0&el=0&r=3&type=normal") != base  # the edit is visible
        get("/edit?i=0&op=rotate&axis=y&deg=30")
        get("/edit?i=0&op=scale&f=1.5")
        assert json.loads(get("/prims"))["prims"][0]["transform"] != t1
        # shift-drag gizmo and camera pan endpoints
        get("/edit?i=0&op=drag&px=20&py=0&az=0&el=0&r=3")
        pan = json.loads(get("/pan?px=30&py=0&az=0&el=0&r=3&cx=0&cy=0&cz=0"))
        assert pan["cx"] != 0.0
        assert get("/frame?az=0&el=0&r=3&cx=0.5")[:8] == PNG_MAGIC
        get("/remove?i=0")
        assert b'"prims": 0' in get("/info")
    finally:
        _stop(srv)


def test_viewer_obj_upload():
    """OBJ insert through the viewer (createLoadMesh)."""
    srv, get = _serve(500, 1, width=48, height=32)
    try:
        port = srv.server_address[1]
        obj = b"v -1 -1 0\nv 1 -1 0\nv 0 1 0\nf 1 2 3\n"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/upload", data=obj,
                                     method="POST")
        assert json.loads(urllib.request.urlopen(req, timeout=120).read())["index"] == 0
        assert b'"prims": 1' in get("/info")
        assert get("/frame?az=0&el=0&r=3&type=normal")[:8] == PNG_MAGIC
    finally:
        _stop(srv)


def test_viewer_fisheye_mirror_frame(tmp_path):
    """The fisheye button with a mirror inserted: the planar-mirror path
    under the fisheye camera; the corner outside the image circle stays
    black."""
    srv, get = _serve(1000, 0)
    try:
        view = "/frame?az=0&el=0&r=3&fisheye=1"
        base = get(view)
        get("/add?kind=plane")
        mirror = get(view + "&type=mirror")
        assert mirror[:8] == PNG_MAGIC and mirror != base
        img = _pixels(tmp_path, mirror)
        assert img.shape == (48, 64, 3) and not img[0, 0].any() and img.max() > 0
    finally:
        _stop(srv)


def test_viewer_sh3_glass_frame(tmp_path):
    """A glass sphere in an SH 3 scene: the fast path at SH 3."""
    srv, get = _serve(1000, 0, config=CFG.replace(sh_degree=3))
    try:
        view = "/frame?az=0&el=0&r=3"
        base = get(view)
        get("/add?kind=sphere")
        glass = get(view + "&type=glass")
        assert glass[:8] == PNG_MAGIC and glass != base
        assert _pixels(tmp_path, glass).shape == (48, 64, 3)
    finally:
        _stop(srv)
