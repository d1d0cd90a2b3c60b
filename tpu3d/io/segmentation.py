"""Instance-segmentation client: SAM-server dispatch + directory fallback.

Mirrors the reference ``Segmentation`` (src/segmentation.cpp):
  - ``get_masks`` tries the SAM server, then falls back to a mask directory
    (segmentation.cpp:54-66);
  - ``get_masks_from_sam`` posts the frame to an HTTP SAM2 endpoint. The
    reference stubs this entirely (prints "not yet implemented",
    segmentation.cpp:44-52); here the HTTP call is implemented but degrades
    to [] on any failure (incl. zero-egress environments), preserving the
    dispatcher's fallback behavior;
  - ``load_masks_from_dir``: sorted png/jpg/jpeg scan, grayscale load,
    binary threshold at 10 (segmentation.cpp:12-42).
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import List

import numpy as np


def _cv2():
    """OpenCV if installed, else None — imported on first use, so the
    demo path never loads it."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def load_masks_from_dir(masks_dir: str) -> List[np.ndarray]:
    if not os.path.isdir(masks_dir):
        print(f"Mask directory not found: {masks_dir}")
        return []
    files = sorted(
        os.path.join(masks_dir, f)
        for f in os.listdir(masks_dir)
        if os.path.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg")
    )
    masks = []
    for path in files:
        m = _imread_gray(path)
        if m is not None:
            masks.append(np.where(m > 10, 255, 0).astype(np.uint8))
    print(f"Loaded {len(masks)} masks from {masks_dir}")
    return masks


def _imread_gray(path: str):
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))
    except Exception:
        return None


def get_masks_from_sam(
    rgb_bgr: np.ndarray, server_url: str, query: str, timeout: float = 10.0
) -> List[np.ndarray]:
    """POST the frame to a SAM2 server; [] on any failure.

    Protocol: JSON {"query": str, "image": base64 PNG} → {"masks": [base64
    PNG, ...]} (the reference never implemented its client; this defines a
    concrete contract for the same config keys).
    """
    if not server_url:
        return []
    try:
        import base64
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgb_bgr[..., ::-1]).save(buf, format="PNG")
        payload = json.dumps(
            {
                "query": query,
                "image": base64.b64encode(buf.getvalue()).decode("ascii"),
            }
        ).encode("utf-8")
        req = urllib.request.Request(
            server_url, data=payload, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
        masks = []
        for b64 in out.get("masks", []):
            img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("L")
            m = np.asarray(img)
            masks.append(np.where(m > 10, 255, 0).astype(np.uint8))
        return masks
    except Exception as e:
        print(f"SAM segmentation unavailable ({e}); falling back")
        return []


def get_masks(
    rgb_bgr: np.ndarray, sam_server_url: str, sam_query: str, masks_dir: str
) -> List[np.ndarray]:
    """Dispatcher matching segmentation.cpp:54-66: SAM first, dir fallback."""
    if sam_server_url:
        masks = get_masks_from_sam(rgb_bgr, sam_server_url, sam_query)
        if masks:
            return masks
    if masks_dir:
        return load_masks_from_dir(masks_dir)
    return []


def resize_mask_nearest(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv::resize INTER_NEAREST equivalent (pipeline.cpp:39-41). Uses the
    native pooled implementation when built (also binarizes at 10, which
    depth_preprocess's > 10 test then passes through unchanged)."""
    if mask.shape == (height, width):
        return mask
    from tpu3d import native

    if native.available():
        out = native.resize_mask_nearest_threshold(mask, height, width)
        if out is not None:
            return out
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(mask, (width, height), interpolation=cv2.INTER_NEAREST)
    ys = (np.arange(height) * mask.shape[0] / height).astype(np.int64)
    xs = (np.arange(width) * mask.shape[1] / width).astype(np.int64)
    return mask[ys[:, None], xs[None, :]]
