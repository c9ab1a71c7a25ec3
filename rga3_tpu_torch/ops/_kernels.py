"""Build and bind the port's CUDA kernels.

The sources under `rga3_tpu_torch/csrc/` are compiled by `nvcc` for sm_90a
into one shared library with a plain C interface, which is loaded with
`ctypes`. The build runs at first use, one `nvcc` per source in parallel and
then one link, into `build/` beside the package (listed in `.gitignore`);
the library's name carries a hash of the sources and flags, so an edit to a
source rebuilds it and an unchanged tree loads the existing file.

The library links its own CUDA runtime, whose current device is not
PyTorch's: every launching entry point takes the ordinal of its tensors'
device first (`launch_on` gives it and PyTorch's current stream there), and
makes that device current before it launches (`csrc/device.cuh`).

Nothing here runs at import time: the CPU tests import every module, and a
machine without the CUDA toolkit has no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "window_attention.cu", "gemm.cu",
           "row_ops.cu", "int4_matmul.cu")
HEADERS = ("attention_mma.cuh", "tma_wgmma.cuh", "device.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # of this process's build, if it built
build_log: str = ""  # nvcc's output (ptxas register/smem lines), kept beside the library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        for name, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        target.with_suffix(".log").write_text(build_log)
        os.replace(tmp_lib, target)  # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.rga3_flash_attention_bf16.argtypes = (
        [i] + [p] * 7 + [i] * 6 + [i64] * 12 + [i, f, p]
    )
    lib.rga3_flash_attention_bf16.restype = i
    lib.rga3_flash_attention_bwd_bf16.argtypes = (
        [i] + [p] * 12 + [i] * 6 + [i64] * 24 + [i, f, p]
    )
    lib.rga3_flash_attention_bwd_bf16.restype = i
    lib.rga3_flash_attention_bwd_scratch_words.argtypes = [i] * 6
    lib.rga3_flash_attention_bwd_scratch_words.restype = i64
    lib.rga3_window_attention_bf16.argtypes = (
        [i] + [p] * 4 + [i] * 6 + [i64] * 12 + [f, p]
    )
    lib.rga3_window_attention_bf16.restype = i
    lib.rga3_gemm_bf16.argtypes = [i, p, i64, p, i64, p, p, i64, p, i64, i, i, i, i, p]
    lib.rga3_gemm_bf16.restype = i
    lib.rga3_layer_norm_bf16.argtypes = [i, p, i64, p, p, p, i64, i, i, f, p]
    lib.rga3_layer_norm_bf16.restype = i
    lib.rga3_window_pool2x2_bf16.argtypes = [i, p, i64, p, i64, i64, i, i, p]
    lib.rga3_window_pool2x2_bf16.restype = i
    lib.rga3_int4_matmul_bf16.argtypes = [i] + [p] * 5 + [i] * 5 + [p]
    lib.rga3_int4_matmul_bf16.restype = i
    lib.rga3_int4_matmul_workspace_words.argtypes = [i] * 3
    lib.rga3_int4_matmul_workspace_words.restype = i64


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this tree has none."""
    global _lib, build_log
    if _lib is None:
        target = BUILD_DIR / f"librga3_kernels_{_digest()}.so"
        if not (target.exists() and target.with_suffix(".log").exists()):
            _build(target)
        else:  # built by an earlier process
            build_log = target.with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(target))
        _bind(lib)
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def launch_on(name: str, *tensors: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(device ordinal, stream handle) of a launch on `tensors` (None
    entries skipped): the one device they lie on and PyTorch's current
    stream there. Raises ValueError, before anything launches, when they lie
    on different devices."""
    given = [t for t in tensors if t is not None]
    dev = given[0].device
    for t in given[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices ({dev} and {t.device})")
    return given[0].get_device(), torch.cuda.current_stream(dev).cuda_stream
