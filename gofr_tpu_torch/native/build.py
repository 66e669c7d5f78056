"""Compile the port's C++ host sources (``src/<name>.cpp``) on demand
and load them with ctypes.

Each library is built once into the git-ignored
``build/gofr_tpu_torch/`` at the repository root, where the CUDA kernels
go too (``ops/_build.py``), as ``<name>-<hash>.so``: the hash covers the
source and the compiler flags, so an edited source rebuilds and an
unchanged one is reused. A build compiles to a temporary file and
renames it into place, so concurrent processes racing the first build
never load a half-written library. ``GOFR_NATIVE=0`` (or ``false`` /
``off``) turns native code off; every consumer then falls back to pure
Python, as it does when no compiler is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "src"
#: git-ignored build directory at the repository root
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gofr_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class NativeBuildError(Exception):
    pass


def compiler() -> str | None:
    """The C++ compiler: ``$CXX``, then ``g++``, then ``clang++``."""
    for cc in (os.environ.get("CXX"), "g++", "clang++"):
        if cc and shutil.which(cc):
            return cc
    return None


def library_path(name: str) -> Path:
    """Where ``src/<name>.cpp``'s library lives: the name carries a hash
    of the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0")
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, cc: str) -> Path:
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=str(BUILD_DIR))
    os.close(fd)
    try:
        proc = subprocess.run(
            [cc, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", tmp],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{cc} failed for {name}: {proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``src/<name>.cpp``; any failure
    raises :class:`NativeBuildError`, so callers can fall back."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        if os.environ.get("GOFR_NATIVE", "1").lower() in ("0", "false",
                                                          "off"):
            raise NativeBuildError("native code disabled via GOFR_NATIVE")
        if not (SRC_DIR / f"{name}.cpp").is_file():
            raise NativeBuildError(f"missing source {SRC_DIR / name}.cpp")
        cc = compiler()
        if cc is None:
            raise NativeBuildError("no C++ compiler on PATH")
        try:
            _loaded[name] = ctypes.CDLL(str(_build(name, cc)))
        except NativeBuildError:
            raise
        except Exception as exc:
            # an unwritable build directory, a compile timeout, a corrupt
            # library: all surface as NativeBuildError
            raise NativeBuildError(
                f"native build of {name} failed: {exc!r}") from exc
        return _loaded[name]


def available(name: str) -> bool:
    try:
        load_library(name)
        return True
    except NativeBuildError:
        return False
