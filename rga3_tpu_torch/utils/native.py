"""The repository's host C++ sources (`native/`) as shared libraries: built
with `g++` into `build/` at first use, the library's name carrying a hash
of the source and flags so that a changed source is built again; a failed
build raises."""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

ROOT = Path(__file__).resolve().parent.parent.parent
BUILD_DIR = ROOT / "build"


def build_native(source: Path, stem: str, flags: Sequence[str] = ()) -> Path:
    """The path of `build/<stem>_<hash>.so` built from `source`."""
    key = source.read_bytes() + " ".join(flags).encode()
    target = BUILD_DIR / f"{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / target.name
            proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", *flags, "-o", str(out),
                                   str(source)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
            os.replace(out, target)
    return target
