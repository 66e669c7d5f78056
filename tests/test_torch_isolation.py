"""The port stands alone: no JAX, no gofr_tpu, no import-time triton,
and its entry points never run on the CPU unless asked to."""

import ast
from pathlib import Path

import pytest
import torch

import gofr_tpu_torch
from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops.flash_attention import flash_attention
from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                paged_decode_attention,
                                                paged_tree_attention)
from gofr_tpu_torch.ops.quant import quantize_int8, wq_gemm
from gofr_tpu_torch.serving.app import build_engine
from gofr_tpu_torch.models.llama import LlamaConfig

torch.set_num_threads(2)

PKG = Path(gofr_tpu_torch.__file__).parent
REPO = PKG.parent
#: the port's modules plus the scripts that drive it on the card
PORT_FILES = sorted(PKG.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "torch_decode_profile.py",
    REPO / "scripts" / "torch_lint.py"]
#: ml_dtypes: the card's machine has none, and the port reads bf16 bytes
#: without it
FORBIDDEN_ANYWHERE = ("jax", "jaxlib", "gofr_tpu", "ml_dtypes")
FORBIDDEN_AT_MODULE_LEVEL = FORBIDDEN_ANYWHERE + ("triton",)


def _imported(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def _module_level_imports(nodes):
    """Imports that run when the module is imported: everything outside
    function and class bodies, top-level if/try blocks included."""
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield from _imported(node)
        yield from _module_level_imports(ast.iter_child_nodes(node))


def _banned(name, roots):
    return any(name == r or name.startswith(r + ".") for r in roots)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_nothing_forbidden(path):
    tree = ast.parse(path.read_text())
    module_level = set(_module_level_imports(tree.body))
    everywhere = {n for node in ast.walk(tree) for n in _imported(node)}
    assert not [n for n in everywhere if _banned(n, FORBIDDEN_ANYWHERE)]
    assert not [n for n in module_level
                if _banned(n, FORBIDDEN_AT_MODULE_LEVEL)]


#: the card's machine has no grpcio and no protobuf: only the gRPC
#: transport and the chat service over it may import them at module level
GRPC_ROOTS = ("grpc", "google.protobuf")
GRPC_MODULES = {PKG / "serving" / "grpc_chat.py", *(PKG / "grpc").glob("*.py")}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_grpc_is_imported_only_by_the_grpc_modules(path):
    tree = ast.parse(path.read_text())
    if path.name == "chip_smoke.py":
        names = {n for node in ast.walk(tree) for n in _imported(node)}
    elif path in GRPC_MODULES:
        return
    else:
        names = set(_module_level_imports(tree.body))
    assert not [n for n in names if _banned(n, GRPC_ROOTS)]


def test_the_port_imports_without_grpc():
    """With ``grpc`` and ``google.protobuf`` unimportable, as on the card's
    machine, the app, the checkpoint, the client and the native code
    import; only the gRPC modules need them."""
    import subprocess
    import sys
    script = (
        "import sys\n"
        "sys.modules['grpc'] = None\n"
        "sys.modules['google.protobuf'] = None\n"
        "import gofr_tpu_torch.serving.app, gofr_tpu_torch.checkpoint\n"
        "import gofr_tpu_torch.service, gofr_tpu_torch.native.bpe\n"
        "import gofr_tpu_torch.native.batch_queue\n"
        "try:\n"
        "    import gofr_tpu_torch.serving.grpc_chat\n"
        "except ImportError:\n"
        "    print('grpc_chat needs grpc')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "grpc_chat needs grpc"


def test_the_scan_sees_every_module_and_catches_a_bad_import():
    names = {p.name for p in PKG.rglob("*.py")}
    assert {"engine.py", "flash_attention.py", "paged_attention.py",
            "paged_kv.py", "llama.py", "glue.py", "app.py",
            "_build.py", "spec.py", "quant.py", "hf_checkpoint.py",
            "tokenizer.py", "metrics.py", "faults.py", "events.py",
            "observability.py", "costmodel.py", "integrity.py",
            "logger.py", "debug.py", "moe.py", "checkpoint.py",
            "grpc_chat.py", "server.py", "protogen.py", "reflection.py",
            "bpe.py", "batch_queue.py", "build.py"} <= names
    assert {p.relative_to(PKG).as_posix() for p in GRPC_MODULES} == {
        "serving/grpc_chat.py", "grpc/__init__.py", "grpc/client.py",
        "grpc/health.py", "grpc/protogen.py", "grpc/reflection.py",
        "grpc/server.py", "grpc/service.py"}
    # the MoE family's model and ops modules are both scanned
    assert {p.relative_to(PKG).as_posix() for p in PKG.rglob("moe.py")} \
        == {"models/moe.py", "ops/moe.py"}
    tree = ast.parse("try:\n    import triton\nexcept ImportError:\n"
                     "    pass\ndef f():\n    import triton.language\n")
    assert set(_module_level_imports(tree.body)) == {"triton"}


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_entry_point_never_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build_engine(LlamaConfig.tiny())          # default device: cuda


@pytest.mark.parametrize("kernel", ["flash", "paged", "chunk", "tree", "wq"])
def test_kernel_wrappers_take_the_plain_path_only_for_cpu_tensors(kernel):
    # a tensor on neither the CPU nor CUDA (the meta device) must raise,
    # not fall through to the plain version
    meta = torch.device("meta")
    if kernel == "wq":
        w = quantize_int8(torch.randn(32, 64), axis=1)      # [N, K]
        w = {"q": w["q"].to(meta), "s": w["s"].to(meta)}
        with pytest.raises(ValueError, match="no kernel"):
            wq_gemm(torch.empty(4, 64, dtype=torch.bfloat16, device=meta), w)
    elif kernel == "flash":
        q = torch.empty(1, 8, 2, 64, dtype=torch.bfloat16, device=meta)
        kv = torch.empty(1, 8, 1, 64, dtype=torch.bfloat16, device=meta)
        with pytest.raises(ValueError, match="no kernel"):
            flash_attention(q, kv, kv)
    else:
        pool = torch.empty(2, 3, 8, 64, dtype=torch.bfloat16, device=meta)
        tables = torch.empty(2, 2, dtype=torch.int32, device=meta)
        lengths = torch.empty(2, dtype=torch.int32, device=meta)
        with pytest.raises(ValueError, match="no kernel"):
            if kernel == "paged":
                q = torch.empty(2, 4, 64, dtype=torch.bfloat16, device=meta)
                paged_decode_attention(q, pool, pool, tables, lengths)
            elif kernel == "chunk":
                q = torch.empty(2, 5, 4, 64, dtype=torch.bfloat16,
                                device=meta)
                paged_chunk_attention(q, pool, pool, tables, lengths,
                                      lengths)
            else:
                q = torch.empty(2, 5, 4, 64, dtype=torch.bfloat16,
                                device=meta)
                masks = torch.empty(2, 5, dtype=torch.int32, device=meta)
                paged_tree_attention(q, pool, pool, tables, lengths, lengths,
                                     masks)


def test_build_hash_covers_the_headers_a_kernel_includes(tmp_path,
                                                         monkeypatch):
    # an edited header must give a new library name, or a stale .so
    # built from the old header would be loaded
    from gofr_tpu_torch.ops import _build
    for name in ("paged_chunk.cu", "flash_attention.cu", "wgmma_attn.cuh",
                 "paged_common.cuh", "paged_decode.cu", "kv_write.cu",
                 "wq_gemm.cu"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = tmp_path / "wgmma_attn.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert after["paged_chunk"] != before["paged_chunk"]
    assert after["flash_attention"] != before["flash_attention"]
    assert after["paged_decode"] == before["paged_decode"]   # no include
    assert after["kv_write"] == before["kv_write"]           # no include
    assert after["wq_gemm"] != before["wq_gemm"]   # its wgmma helpers


#: JAX packages the port keeps as one module each
PACKAGE_AS_MODULE = {"metrics": "metrics.py", "service": "service.py"}


def test_every_jax_module_has_a_port_counterpart():
    """Each ``gofr_tpu/**/*.py`` has a file of the same path in the port,
    or its package is one module there (``PACKAGE_AS_MODULE``); a JAX
    module added without a counterpart fails this."""
    jax_pkg = REPO / "gofr_tpu"
    missing = []
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg)
        if (PKG / rel).exists():
            continue
        if PACKAGE_AS_MODULE.get(rel.parts[0]) and \
                (PKG / PACKAGE_AS_MODULE[rel.parts[0]]).exists():
            continue
        missing.append(rel.as_posix())
    assert missing == []
    assert all((jax_pkg / name).is_dir() and not (PKG / name).is_dir()
               for name in PACKAGE_AS_MODULE)
