"""Build the hand-written CUDA kernels in ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/gofr_tpu_torch/<name>-<hash>.so``
(``-gencode arch=compute_90a,code=sm_90a``: Hopper, with the ``a``
features), then loaded with ctypes. The file name carries a hash of
the source, the ``csrc/`` headers it includes (``wgmma_attn.cuh``,
``paged_common.cuh``, ``attn_simt.cuh``, ``act_types.cuh``) and the
flags, so an edited kernel or header
rebuilds and an unchanged one is reused. Nothing here runs at import: the first call
of a kernel's wrapper builds and loads it, and :func:`build_all`
builds every kernel at once (one ``nvcc`` per source, all started
together) for scripts that want the build out of the way.

The kernels include no PyTorch headers, so a build takes seconds;
pointers and the stream travel as integers from ``Tensor.data_ptr()``
and ``torch.cuda.current_stream().cuda_stream``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: git-ignored build directory at the repository root
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gofr_tpu_torch"

#: kernel name -> source file under csrc/
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "paged_decode": "paged_decode.cu",
    "paged_chunk": "paged_chunk.cu",
    "kv_write": "kv_write.cu",
    "wq_gemm": "wq_gemm.cu",
}

#: the activation types the kernels take, by the code their C entries
#: read as ``dtype``
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def check_head_dim(name: str, d: int) -> None:
    """Raise ``ValueError`` unless the kernels take head dim ``d``: the
    bf16 tensor-core kernels hold 64 and 128, ``csrc/attn_simt.cuh`` and
    ``kv_write.cu``'s general kernels every other multiple of 4 from 16
    to 256."""
    if not (16 <= d <= 256 and d % 4 == 0):
        raise ValueError(f"{name}: head_dim {d}; the kernels take a "
                         f"multiple of 4 from 16 to 256")


def dtype_code(name: str, what: str, dtype: torch.dtype) -> int:
    """The C entries' ``dtype`` code of an activation type, or raise
    ``TypeError``."""
    code = KERNEL_DTYPES.get(dtype)
    if code is None:
        raise TypeError(f"{name}: {what} must be bfloat16, float16 or "
                        f"float32, got {dtype}")
    return code


def wgmma_route(dtype: torch.dtype, d: int) -> bool:
    """True where the attention C entries launch the bf16 tensor-core
    (``wgmma``) kernels, which alone split a walk over a cluster: bf16 at
    head dim 64 or 128. Every other case runs ``csrc/attn_simt.cuh``."""
    return dtype == torch.bfloat16 and d in (64, 128)


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build made
#: by this process, by kernel name
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then the toolkit's
    default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(path: Path, seen: dict[Path, bytes]) -> None:
    """``path`` and every local ``#include "..."`` it reaches (resolved
    beside the including file, as nvcc does), recursively, into
    ``seen`` (file -> bytes)."""
    if path in seen:
        return
    text = path.read_bytes()
    seen[path] = text
    for inc in _LOCAL_INCLUDE.findall(text):
        dep = (path.parent / inc.decode()).resolve()
        if dep.is_file():
            _sources_of(dep, seen)


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: the hash covers its source,
    the local headers it includes, and the compiler flags."""
    files: dict[Path, bytes] = {}
    _sources_of((CSRC / SOURCES[name]).resolve(), files)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(files):
        h.update(path.name.encode() + b"\0" + files[path])
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its hashed library exists; the
    output is written under a temporary name and renamed, so a
    concurrent loader never sees half a file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    build_logs[name] = proc.stderr
    os.replace(tmp, out)
    return out


def build_all(names=None) -> dict[str, float]:
    """Build the named kernels (default: all) in parallel; returns the
    seconds each build took (0.0-ish when it was already built)."""
    names = list(names or SOURCES)

    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {n: pool.submit(timed, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
