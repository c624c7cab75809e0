"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``ops/csrc/<name>.cu`` holds kernels plus ``extern "C"`` launchers and
includes no PyTorch header, so one ``nvcc`` call builds it in seconds. The
shared library lands in ``build/torch_kernels/`` at the repository root,
named by a hash of the sources and flags: an edited source builds anew, an
unchanged one is loaded as it is. Nothing is built at import time; the first
call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to compile in this process (absent when the
#: library was already built on disk)
build_seconds: Dict[str, float] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library unless a build of
    the same sources and flags exists; returns its path."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{_digest(src)}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def edit_pairs(edit) -> list:
    """The ``(old, new)`` string replacements of one edit: None (none), one
    pair, or a list of pairs."""
    if edit is None:
        return []
    return [edit] if isinstance(edit[0], str) else list(edit)


def build_edited(name: str, edits: dict, tmp: Path) -> Dict[str, ctypes.CDLL]:
    """Copies of ``csrc/<name>.cu`` in ``tmp``, each made by the string
    replacements of one edit (:func:`edit_pairs`), built with NVCC_FLAGS in
    parallel and loaded; keyed as ``edits``. Raises when a source no longer
    holds a string to replace or nvcc fails."""
    src = (CSRC / f"{name}.cu").read_text()
    for header in CSRC.glob("*.cuh"):
        (tmp / header.name).write_text(header.read_text())
    procs = {}
    for key, edit in edits.items():
        text = src
        for old, new in edit_pairs(edit):
            if old not in text:
                raise RuntimeError(f"{key}: the source no longer has {old!r}")
            text = text.replace(old, new)
        (tmp / f"{key}.cu").write_text(text)
        procs[key] = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp / f"{key}.so"),
             str(tmp / f"{key}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(tmp / f"{key}.so"))
    return libs
