"""COCO RLE mask codec, counterpart of `rga3_tpu/utils/rle.py`.

Masks are (h, w) binary arrays; an RLE is `{"size": [h, w], "counts": str}`
with column-major runs that start with a (possibly empty) background run,
written in COCO's compressed string form (5-bit groups with a continuation
bit, offset by 48, counts after the second stored as the difference to the
count two before). `decode` also takes a list of counts.

`decode`, `encode`, `area`, `to_bbox` and `merge` run the repository's
native codec (`native/rle.cpp`), built with `g++` into `build/` at first
use (the library's name carries a hash of the source); they raise if it
cannot be built or reports malformed counts. `decode_plain` /
`encode_plain` (and the string codec `counts_from_string_plain` /
`counts_to_string_plain`) are the plain numpy versions.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .native import ROOT, build_native

SOURCE = ROOT / "native" / "rle.cpp"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library() -> ctypes.CDLL:
    """The native codec, built on first use; raises if `g++` fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native(SOURCE, "librle")))
        lib.rle_decode.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _U8P]
        lib.rle_decode.restype = ctypes.c_int32
        lib.rle_encode.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, _I64P, ctypes.c_int64]
        lib.rle_encode.restype = ctypes.c_int64
        lib.rle_from_string.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I64P, ctypes.c_int64]
        lib.rle_from_string.restype = ctypes.c_int64
        lib.rle_to_string.argtypes = [_I64P, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.rle_to_string.restype = ctypes.c_int64
        _lib = lib
        return lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


# ---- the compressed string form


def counts_from_string(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, str):
        s = s.encode("ascii")
    buf = np.empty(len(s) + 1, np.int64)
    n = library().rle_from_string(s, len(s), _i64p(buf), buf.size)
    if n < 0:
        raise ValueError("truncated RLE string")
    return buf[:n].tolist()


def counts_to_string(counts: Sequence[int]) -> str:
    arr = np.ascontiguousarray(counts, np.int64)
    out = ctypes.create_string_buffer(13 * arr.size + 16)  # 13 groups hold any int64
    m = library().rle_to_string(_i64p(arr), arr.size, out, len(out))
    if m < 0:
        raise ValueError("RLE string buffer too small")
    return out.raw[:m].decode("ascii")


def counts_from_string_plain(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = k = 0
        more = True
        while more:
            if i >= len(s):
                raise ValueError("truncated RLE string")
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and c & 0x10:
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def counts_to_string_plain(counts: Sequence[int]) -> str:
    s = bytearray()
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if c & 0x10 else (x != 0)
            s.append((c | 0x20 if more else c) + 48)
    return s.decode("ascii")


# ---- masks


def decode(rle: Dict[str, Any]) -> np.ndarray:
    """RLE -> (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = counts_from_string(counts)
    out = np.zeros((h, w), np.uint8)
    if h * w == 0:
        return out
    arr = np.ascontiguousarray(counts, np.int64)
    if library().rle_decode(_i64p(arr), arr.size, h, w, _u8p(out)) != 0:
        raise ValueError(f"RLE counts do not fit a {h}x{w} mask")
    return out


def encode(mask: np.ndarray) -> Dict[str, Any]:
    """(h, w) binary mask -> compressed RLE."""
    h, w = mask.shape
    if h * w == 0:
        return {"size": [h, w], "counts": counts_to_string([0])}
    m = np.ascontiguousarray(mask != 0, np.uint8)
    counts = np.empty(h * w + 2, np.int64)
    n = library().rle_encode(_u8p(m), h, w, _i64p(counts), counts.size)
    if n < 0:
        raise ValueError("RLE counts buffer too small")
    return {"size": [h, w], "counts": counts_to_string(counts[:n])}


def decode_plain(rle: Dict[str, Any]) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = counts_from_string_plain(counts)
    if any(c < 0 for c in counts) or sum(counts) > h * w:
        raise ValueError(f"RLE counts do not fit a {h}x{w} mask")
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    for i, c in enumerate(counts):
        if i % 2:
            flat[pos:pos + c] = 1
        pos += c
    return np.ascontiguousarray(flat.reshape(w, h).T)  # column-major runs


def encode_plain(mask: np.ndarray) -> Dict[str, Any]:
    h, w = mask.shape
    flat = (np.asarray(mask) != 0).T.reshape(-1).astype(np.uint8)
    if flat.size == 0:
        return {"size": [h, w], "counts": counts_to_string_plain([0])}
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0]:
        runs = [0] + runs
    return {"size": [h, w], "counts": counts_to_string_plain(runs)}


def area(rle: Dict[str, Any]) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = counts_from_string(counts)
    return int(sum(counts[1::2]))


def to_bbox(rle: Dict[str, Any]) -> np.ndarray:
    """[x, y, w, h] of the mask's bounding box (zeros when empty)."""
    ys, xs = np.nonzero(decode(rle))
    if ys.size == 0:
        return np.zeros(4, np.float64)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
                      np.float64)


def merge(rles: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The union of the masks."""
    m = decode(rles[0])
    for r in rles[1:]:
        m |= decode(r)
    return encode(m)
