"""gofr_tpu_torch — the PyTorch + CUDA port of gofr_tpu's serving path.

Mirrors the layout of ``gofr_tpu/`` (``ops/``, ``models/``,
``parallel/``, ``serving/``, and the framework: ``app.py``, ``http/``, ``handler.py``,
``context.py``, ``container/``, ``config/``, ``logging/``,
``websocket/``, ``datasource/``, ``crud.py``, ``migrations/``, ``cli/``,
``analysis/``; every module of ``gofr_tpu/`` has its counterpart, JAX's
``metrics/`` and ``service/`` packages as one module each) so each
function's counterpart is found by name. The
package imports ``torch`` and numpy, never ``jax`` and nothing of
``gofr_tpu``: what it needs from there it keeps as its own copy.

Every kernel that ``gofr_tpu`` writes in Pallas for the TPU is a
hand-written CUDA C++ kernel for Hopper here (``csrc/``), built by
``nvcc`` at first use (``ops/_build.py``) and bound through ctypes.
Each kernel's wrapper runs the kernel for CUDA tensors and its plain
PyTorch version for CPU tensors — the CPU path exists for the tests,
never as a fallback for a CUDA tensor.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``
(:func:`gofr_tpu_torch.device.resolve_device`). Importing this package
builds nothing and imports neither ``triton`` nor a CUDA library.
"""
