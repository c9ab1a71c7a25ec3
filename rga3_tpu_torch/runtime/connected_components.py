"""Connected components and hole filling of masks on the host, counterpart
of `rga3_tpu/runtime/connected_components.py`.

`get_connected_components` runs the repository's union-find labeller
(`native/connected_components.cpp`, 8-connectivity), built with `g++` into
`build/` at first use (the library's name carries a hash of the source); it
raises if the library cannot be built. (The JAX package's build of that
source fails with g++ 12 for want of `<cstddef>`, and it then labels with its
numpy fallback; this build includes the header.) `cc_plain` is the plain numpy
version, for tests.

`fill_holes_in_mask_scores`: background components (score <= 0) of area at
most `max_area` become foreground with score 0.1.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from ..utils.native import ROOT, build_native

SOURCE = ROOT / "native" / "connected_components.cpp"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_I32P = ctypes.POINTER(ctypes.c_int32)


def library() -> ctypes.CDLL:
    """The native labeller, built on first use; raises if `g++` fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        # the source uses size_t without including a header that declares
        # it in the global namespace
        lib = ctypes.CDLL(str(build_native(SOURCE, "libcc", ("-include", "cstddef"))))
        lib.connected_components.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _I32P, _I32P,
        ]
        lib.connected_components.restype = None
        _lib = lib
        return lib


def cc_plain(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, areas) of one (H, W) plane by flood fill, 8-connectivity:
    components numbered from 1 in raster order of their first pixel, each
    pixel carrying its component's area."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    areas = np.zeros((h, w), np.int32)
    next_id = 1
    for y0 in range(h):
        for x0 in range(w):
            if not mask[y0, x0] or labels[y0, x0]:
                continue
            stack = [(y0, x0)]
            labels[y0, x0] = next_id
            pix = []
            while stack:
                y, x = stack.pop()
                pix.append((y, x))
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        ny, nx = y + dy, x + dx
                        if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and not labels[ny, nx]:
                            labels[ny, nx] = next_id
                            stack.append((ny, nx))
            for y, x in pix:
                areas[y, x] = len(pix)
            next_id += 1
    return labels, areas


def get_connected_components(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """mask: (N, H, W) or (N, 1, H, W), nonzero foreground. Returns int32
    (labels, areas) of the same shape, 8-connectivity."""
    squeeze = mask.ndim == 4
    if squeeze:
        mask = mask[:, 0]
    if mask.ndim != 3:
        raise ValueError(f"get_connected_components: mask of shape {mask.shape}")
    m = np.ascontiguousarray(mask.astype(np.uint8))
    n, h, w = m.shape
    labels = np.zeros(m.shape, np.int32)
    areas = np.zeros(m.shape, np.int32)
    library().connected_components(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
        labels.ctypes.data_as(_I32P), areas.ctypes.data_as(_I32P))
    if squeeze:
        labels, areas = labels[:, None], areas[:, None]
    return labels, areas


def fill_holes_in_mask_scores(mask_scores: np.ndarray, max_area: int) -> np.ndarray:
    """(N, 1, H, W) or (N, H, W) float scores with the background
    components of area <= max_area set to 0.1."""
    if max_area <= 0:
        raise ValueError("max_area must be positive")
    labels, areas = get_connected_components(mask_scores <= 0)
    out = mask_scores.copy()
    out[(labels > 0) & (areas <= max_area)] = 0.1
    return out
