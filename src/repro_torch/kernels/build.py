"""Builds a hand-written CUDA source into a shared library with a plain C
interface and loads it with ``ctypes``; one builder for every kernel of
the port.

A source compiles at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/lib<name>_<key>.so`` at the repository root, where the
key hashes the source and the flags, so an edited source never loads a
stale library. Several processes compiling one library (spawned
serverless workers) take turns under a file lock: the first compiles, the
others load its result. Nothing is built or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}


def _nvcc(name: str) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"nvcc not found: the {name} kernel cannot be built")


def build(source: Path, name: str) -> Tuple[Path, str]:
    """Compile ``source`` into ``lib<name>_<key>.so`` unless a build of
    this exact source and these flags exists. Returns ``(path, compiler
    output)``; the output is empty when the build was already there."""
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{key}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".lib{name}_{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if lib.exists():                   # another process built it
            return lib, ""
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                                   str(source)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{source.name}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, lib)   # atomic: a reader never sees half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(source: Path, name: str,
         bind: Callable[[ctypes.CDLL, Path], None]) -> ctypes.CDLL:
    """Build (if needed) and load ``source`` once per process. ``bind``
    declares the library's ``argtypes``/``restype`` and checks its launch
    geometry against the wrapper's; it raises on a mismatch, and then the
    library is not kept."""
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build(source, name)
        lib = ctypes.CDLL(str(path))
        bind(lib, path)
        _loaded[source] = lib
    return lib


def check_error(lib: ctypes.CDLL, prefix: str, err: int) -> None:
    """Raise if a launch returned a CUDA error; ``prefix`` names the
    library's ``<prefix>_error_string``."""
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{prefix} launch failed: CUDA error {err} ({msg})")
