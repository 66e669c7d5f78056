"""Build the hand-written CUDA kernels in ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/gofr_tpu_torch/<name>-<hash>.so``
(``-gencode arch=compute_90a,code=sm_90a``: Hopper, with the ``a``
features), then loaded with ctypes. A source whose kernels come in every
type and pool form (``PARTS``) is compiled in parts, one ``nvcc`` each,
all started together, and the parts' objects are linked into its one
library. The file name carries a hash of
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

#: sources compiled in parts: part i (``-DGOFR_PART=i``) instantiates
#: one (activation type, pool form)'s kernels, part 0 also the C entries;
#: nvcc compiles one translation unit's kernels one after another
PARTS = {"paged_decode": 6, "paged_chunk": 4}

#: the activation types the kernels take, by the code their C entries
#: read as ``dtype``
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def check_head_dim(name: str, d: int) -> None:
    """Raise ``ValueError`` unless the kernels take head dim ``d``: a
    multiple of 4 from 16 to 256 (the attention kernels stage it padded
    to their head-dim class, ``kv_write.cu`` writes it as it is)."""
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


#: the attention kernels, by the name :func:`attention_route` takes
ATTENTION_KERNELS = ("flash", "decode", "chunk", "tree")


def attention_route(kernel: str, dtype: torch.dtype, d: int) -> str:
    """The hand-written kernel an attention call of ``kernel`` (one of
    ATTENTION_KERNELS) runs for activations of ``dtype`` at head dim
    ``d``, as the C entries pick it:

    - ``"split_kv"``: ``csrc/paged_decode.cu``, every decode, in every
      type (S blocks share a walk, merged in a thread-block cluster);
    - ``"wgmma"``: ``csrc/flash_attention.cu`` and ``csrc/paged_chunk.cu``
      on the tensor-core core of ``csrc/wgmma_attn.cuh``, bf16 and
      float16 flash, chunk and tree (chunk and tree split too);
    - ``"simt"``: ``csrc/attn_simt.cuh``, float32 flash, chunk and tree
      in float32 FMAs (TF32 is not JAX's float32), unsplit.

    Every head dim the kernels take runs the same route (a head dim that
    is not the kernel's class is staged padded to it). Raises on a kernel
    name, type or head dim the kernels do not take."""
    if kernel not in ATTENTION_KERNELS:
        raise ValueError(f"attention_route: unknown kernel {kernel!r}")
    dtype_code(kernel, "q", dtype)
    check_head_dim(kernel, d)
    if kernel == "decode":
        return "split_kv"
    return "simt" if dtype == torch.float32 else "wgmma"


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: one part's compile: the same flags, an object instead of a library
PART_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

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
    h.update(f"parts {PARTS.get(name, 1)}".encode())
    for path in sorted(files):
        h.update(path.name.encode() + b"\0" + files[path])
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _run_nvcc(name: str, args: list) -> str:
    """One ``nvcc`` run; its stderr (the ptxas report), or raise."""
    proc = subprocess.run([nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    return proc.stderr


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its hashed library exists (a source
    in ``PARTS``: its parts at once, then one link); the output is written
    under a temporary name and renamed, so a concurrent loader never sees
    half a file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src = str(CSRC / SOURCES[name])
    parts = PARTS.get(name, 1)
    objs = [tmp.with_suffix(f".{i}.o") for i in range(parts)]
    try:
        if parts == 1:
            logs = [_run_nvcc(name, [*NVCC_FLAGS, "-o", str(tmp), src])]
        else:
            with ThreadPoolExecutor(max_workers=parts) as pool:
                logs = list(pool.map(lambda i: _run_nvcc(name, [
                    *PART_FLAGS, f"-DGOFR_PART={i}", "-o", str(objs[i]),
                    src]), range(parts)))
            _run_nvcc(name, ["-shared", "-o", str(tmp), *map(str, objs)])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_logs[name] = "".join(logs)
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
