"""Native (C++) host code of the port (copies of ``gofr_tpu/native/``).

The host-side hot paths around the model are C++ compiled on demand
(:mod:`.build`, ``g++`` or ``clang++``), with pure-Python fallbacks so
that nothing requires a toolchain:

- :mod:`.bpe`: the byte-pair tokenizer's merge loop (request admission);
- :mod:`.batch_queue`: a waitable MPMC batch queue whose blocking pops
  release the GIL.

The device path is PyTorch and the CUDA kernels of ``csrc/``; this is
the host code around it.
"""

from .build import NativeBuildError, available, compiler  # noqa: F401
