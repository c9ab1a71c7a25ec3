"""Reader and writer of the safetensors file format, in numpy and torch.

A file is an 8-byte little-endian header length N, then N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`, offsets relative to the end of the header), then the tensors' raw
little-endian bytes. Types: F32, F16, BF16, I8, U8, I32, I64. numpy has no
bfloat16, so a BF16 tensor reads as uint16 in numpy and as
`torch.bfloat16` in torch.

The port reads and writes checkpoints with this module alone: the card has
no `safetensors` package.
"""
from __future__ import annotations

import json
import os
import struct
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the raw bytes, torch dtype)
DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "I32": (np.int32, torch.int32),
    "I64": (np.int64, torch.int64),
}
_FROM_TORCH = {t: name for name, (_, t) in DTYPES.items()}
_FROM_NUMPY = {np.dtype(n): name for name, (n, _) in DTYPES.items() if name != "BF16"}
WRITE_AHEAD = 2  # tensors copied to the host ahead of the one being written

Array = Union[np.ndarray, torch.Tensor]


def _read_raw_header(path: str) -> Tuple[dict, int]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(the tensors' entries by name, the byte offset of the data)."""
    header, start = _read_raw_header(path)
    header.pop("__metadata__", None)
    return header, start


def read_metadata(path: str) -> Dict[str, str]:
    """The file's `__metadata__` (string to string), or {}."""
    return _read_raw_header(path)[0].get("__metadata__", {})


def iter_file(path: str, framework: str = "pt") -> Iterator[Tuple[str, Array]]:
    """(name, tensor) for every tensor of the file, in file order: torch
    tensors (`framework="pt"`) or numpy arrays (`"np"`, BF16 as uint16).
    Each tensor owns its memory, read into it straight from the file."""
    if framework not in ("pt", "np"):
        raise ValueError(f"framework must be 'pt' or 'np', got {framework!r}")
    header, start = read_header(path)
    with open(path, "rb", buffering=0) as f:
        for name, e in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype {e['dtype']}")
            np_dtype, torch_dtype = DTYPES[e["dtype"]]
            b, end = e["data_offsets"]
            buf = np.empty(end - b, np.uint8)
            f.seek(start + b)
            view, got = memoryview(buf), 0
            while got < len(buf):
                n = f.readinto(view[got:])
                if not n:
                    raise ValueError(f"{path}: the file ends inside {name}")
                got += n
            arr = buf.view(np_dtype).reshape(e["shape"])
            if framework == "np":
                yield name, arr
            else:
                t = torch.from_numpy(arr)
                yield name, t.view(torch_dtype) if e["dtype"] == "BF16" else t


def load_file(path: str, framework: str = "pt") -> Dict[str, Array]:
    return dict(iter_file(path, framework))


def _entry(name: str, x: Array) -> Tuple[str, list, int]:
    """(safetensors dtype, shape, bytes) of a tensor or array, without
    copying it."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _FROM_TORCH:
            raise ValueError(f"{name}: unsupported dtype {x.dtype}")
        return _FROM_TORCH[x.dtype], list(x.shape), x.numel() * x.element_size()
    arr = np.asarray(x)
    if arr.dtype not in _FROM_NUMPY:
        raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
    return _FROM_NUMPY[arr.dtype], list(arr.shape), arr.nbytes


def _raw(x: Array) -> np.ndarray:
    """A contiguous little-endian numpy view of the bytes (a tensor is
    copied to the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return (x.view(torch.uint16) if x.dtype == torch.bfloat16 else x).numpy()
    arr = np.asarray(x, order="C")  # ascontiguousarray would make a 0-d array 1-d
    return arr.astype(arr.dtype.newbyteorder("<"), copy=False)


def save_file(tensors: Mapping[str, Array], path: str,
              metadata: Mapping[str, str] = None) -> int:
    """Write `tensors` (numpy arrays or torch tensors) in name order, as the
    safetensors package does, with an optional `__metadata__`; the header
    is padded with spaces to a multiple of 8 bytes. The file is written
    under a temporary name, one tensor at a time (a tensor on the card is
    copied to the host a few tensors ahead of its turn, on a thread of its
    own, while the earlier ones are written), and renamed into place, so
    an interrupted write leaves any earlier file whole. Returns the bytes
    written."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    names = sorted(tensors)
    for name in names:
        dt, shape, n = _entry(name, tensors[name])
        header[name] = {"dtype": dt, "shape": shape, "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f, ThreadPoolExecutor(1) as ex:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        pending = deque(ex.submit(_raw, tensors[n]) for n in names[:WRITE_AHEAD])
        for i, name in enumerate(names):
            arr = pending.popleft().result()
            if i + WRITE_AHEAD < len(names):
                pending.append(ex.submit(_raw, tensors[names[i + WRITE_AHEAD]]))
            f.write(arr.reshape(-1).view(np.uint8).data)
    os.replace(tmp, path)
    return 8 + len(text) + offset
