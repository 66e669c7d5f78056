"""The port stands alone: no JAX, no gofr_tpu, no import-time triton,
and its entry points never run on the CPU unless asked to. And it does
all that the JAX package does: every JAX module has a counterpart file;
every public name (top-level functions and classes, their public
methods and ``__init__``) has a counterpart of the same qualified name,
or is listed in ``RENAMED`` / ``JAX_ONLY`` with a reason; and every
parameter of a JAX function is taken by its counterpart, or is listed in
``PARAM_RENAMED`` / ``PARAM_JAX_ONLY`` with a reason. A listed entry
with no reason, or no longer needed, fails as a gap does."""

import ast
import inspect
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
#: the port's modules, the scripts that drive it (on the card and as an
#: operator's tools) and the apps built on it
PORT_FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] \
    + sorted((REPO / "scripts").glob("torch_*.py")) \
    + sorted((REPO / "examples_torch").rglob("*.py"))
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


# ------------------------------------------------ names and parameters
#: Public JAX names whose port counterpart has another name:
#: "module:qualified name" -> (the port's qualified name, reason). A
#: renamed class carries its methods with it.
RENAMED = {
    "grpc/server.py:GRPCRequest": (
        "RPCContext",
        "the handler's view of one RPC: the port's also carries the "
        "container's slots, the tenant, grpc's servicer context and the "
        "server's pool, so it is the RPC's context, not its request"),
    "serving/control_plane.py:ShardAssignment.jax_initialize_args": (
        "ShardAssignment.dist_init_args",
        "the arguments of torch.distributed.init_process_group where JAX "
        "hands jax.distributed.initialize its own"),
}

CACHE = ("XLA's persistent compile cache; the port's kernels are built "
         "by nvcc into a content-hashed library (ops/_build.py) and its "
         "decode dispatch is a CUDA graph captured at run time")
ROUTE = ("a Pallas or XLA route of the paged op, chosen by the caller in "
         "JAX; the port routes by the tensors' device (the CUDA kernel, "
         "or its plain version for CPU tensors), so a plain path chosen "
         "by the caller cannot hide the kernel")
#: Public JAX names with no port counterpart, and why none is needed
JAX_ONLY = {
    "config/env.py:default_compile_cache_dir": CACHE,
    "config/env.py:resolve_compile_cache_dir": CACHE,
    "config/env.py:enable_compile_cache": CACHE,
    "device.py:DeviceRegistry.metrics_loop": (
        "a deviation kept on purpose: the port refreshes the device "
        "gauges on every metrics scrape (App's metrics handler), where "
        "JAX runs this loop every 15 s"),
    "ops/paged_attention.py:paged_decode_attention_pallas": ROUTE,
    "ops/paged_attention.py:paged_decode_attention_xla": ROUTE,
    "ops/paged_attention.py:paged_chunk_attention_pallas": ROUTE,
    "ops/paged_attention.py:paged_chunk_attention_xla": ROUTE,
    "ops/paged_attention.py:paged_tree_attention_pallas": ROUTE,
    "ops/paged_attention.py:paged_tree_attention_xla": ROUTE,
    "parallel/mesh.py:shard_map_compat": (
        "jax.experimental.shard_map across JAX versions; the port's "
        "ranks run their shards' code directly over torch.distributed "
        "(parallel/comm.py)"),
    "parallel/mesh.py:named": (
        "a NamedSharding of a PartitionSpec on a jax Mesh; the port "
        "places shards with parallel/sharding.Sharding"),
    "serving/observability.py:jit_cost_flops": (
        "XLA's cost analysis of a jitted function; the port counts a "
        "step's FLOPs with llama_decode_flops (held against "
        "torch.utils.flop_counter in the tests)"),
}

GENERATOR = ("a jax.random key is a torch.Generator in the port (the "
             "randomness of a seeded init or sample)")
TILING = ("Pallas's block sizes: the CUDA kernels pick their tiles from "
          "the shapes")
IMPLEMENTATION = ROUTE
#: JAX parameters the port's counterpart takes under another name:
#: "module:qualified name:parameter" -> (the port's name, reason)
PARAM_RENAMED = {
    "models/llama.py:llama_init:key": ("generator", GENERATOR),
    "models/moe.py:moe_init:key": ("generator", GENERATOR),
    "models/bert.py:bert_init:key": ("generator", GENERATOR),
    "models/whisper.py:whisper_init:key": ("generator", GENERATOR),
    "ops/sampling.py:sample_tokens:key": ("generator", GENERATOR),
    "parallel/train.py:make_train_state:key": ("generator", GENERATOR),
    "grpc/server.py:GRPCServer.__init__:container": (
        "host_server",
        "C14: the port's gRPC server is hosted by an App or a ChatServer "
        "(its container, logger, metrics and tenant rule)"),
}
#: JAX parameters the port's counterpart does not take, and why
PARAM_JAX_ONLY = {
    "ops/attention.py:attention:block_q": TILING,
    "ops/attention.py:attention:block_k": TILING,
    "ops/flash_attention.py:flash_attention:block_q": TILING,
    "ops/flash_attention.py:flash_attention:block_k": TILING,
    "ops/flash_attention.py:flash_attention:interpret": (
        "Pallas's interpret mode; a CUDA kernel has none, and a CPU "
        "tensor takes the plain version"),
    "ops/paged_attention.py:paged_decode_attention:implementation":
        IMPLEMENTATION,
    "ops/paged_attention.py:paged_chunk_attention:implementation":
        IMPLEMENTATION,
    "ops/paged_attention.py:paged_tree_attention:implementation":
        IMPLEMENTATION,
    "serving/glue.py:llama_engine:implementation": IMPLEMENTATION,
    "serving/glue.py:moe_engine:implementation": IMPLEMENTATION,
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _is_property(fn) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               or isinstance(d, ast.Attribute) and d.attr in ("setter",
                                                              "getter")
               for d in fn.decorator_list)


def _jax_surface() -> dict:
    """"module:qualified name" -> its parameters (None for a class or a
    property) for every public top-level function and class of
    ``gofr_tpu/**/*.py``, their public methods and ``__init__``."""
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for path in sorted((REPO / "gofr_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "gofr_tpu").as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, funcs) and _public(node.name):
                out[f"{rel}:{node.name}"] = _params(node)
            elif isinstance(node, ast.ClassDef) and _public(node.name):
                out[f"{rel}:{node.name}"] = None
                for item in node.body:
                    if isinstance(item, funcs) and (
                            _public(item.name) or item.name == "__init__"):
                        out[f"{rel}:{node.name}.{item.name}"] = (
                            None if _is_property(item) else _params(item))
    return out


def _port_module(rel: str):
    import importlib
    parts = Path(rel).with_suffix("").parts
    if parts[0] in PACKAGE_AS_MODULE and not (PKG / rel).exists():
        parts = parts[:1]
    elif parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(("gofr_tpu_torch",) + parts))


def _port_name(key: str, renames: dict = RENAMED) -> str:
    """The port's qualified name for ``key``: its own rename, else its
    class's, else the JAX name."""
    rel, qual = key.split(":")
    if key in renames:
        return renames[key][0]
    head, dot, rest = qual.partition(".")
    if dot and f"{rel}:{head}" in renames:
        return f"{renames[f'{rel}:{head}'][0]}.{rest}"
    return qual


def _port_object(key: str, renames: dict = RENAMED):
    """The port's counterpart of JAX's ``key``, or None."""
    rel = key.split(":")[0]
    obj = _port_module(rel)
    for part in _port_name(key, renames).split("."):
        try:
            obj = (inspect.getattr_static(obj, part)
                   if isinstance(obj, type) else getattr(obj, part))
        except AttributeError:
            return None
    return obj


def _port_params(obj) -> set:
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    return set(inspect.signature(obj).parameters)


def _name_findings(surface: dict, renamed: dict, jax_only: dict) -> dict:
    """What the name test finds: JAX names with no counterpart, listed
    entries with no reason, and entries no longer needed."""
    found = {"missing": [], "no_reason": [], "not_needed": []}
    found["no_reason"] = sorted(
        [k for k, (_, why) in renamed.items() if not why.strip()]
        + [k for k, why in jax_only.items() if not why.strip()])
    for key in sorted(set(renamed) | set(jax_only)):
        if key not in surface or _port_object(key, {}) is not None:
            found["not_needed"].append(key)
    for key in surface:
        if key in jax_only:
            continue
        if _port_object(key, renamed) is None:
            found["missing"].append(key)
    return found


def _param_findings(surface: dict, renamed: dict, jax_only: dict) -> dict:
    """What the parameter test finds: JAX parameters the port's
    counterpart does not take, listed entries with no reason, and
    entries no longer needed (the port takes JAX's name, JAX has no such
    parameter, or the port does not take the name a rename gives)."""
    found = {"missing": [], "no_reason": [], "not_needed": []}
    found["no_reason"] = sorted(
        [k for k, (_, why) in renamed.items() if not why.strip()]
        + [k for k, why in jax_only.items() if not why.strip()])
    seen = set()
    for key, params in surface.items():
        if params is None or key in JAX_ONLY:
            continue
        obj = _port_object(key)
        if obj is None or isinstance(obj, property):
            continue
        taken = _port_params(obj)
        for name in params:
            entry = f"{key}:{name}"
            if entry in renamed:
                seen.add(entry)
                if name in taken or renamed[entry][0] not in taken:
                    found["not_needed"].append(entry)
            elif entry in jax_only:
                seen.add(entry)
                if name in taken:
                    found["not_needed"].append(entry)
            elif name not in taken:
                found["missing"].append(entry)
    found["not_needed"] += sorted((set(renamed) | set(jax_only)) - seen)
    return found


def test_every_jax_public_name_has_a_port_counterpart():
    """Each public top-level function and class of ``gofr_tpu/**/*.py``,
    each public method and ``__init__`` of those classes, has a
    counterpart of the same qualified name in the port's counterpart
    module (``PACKAGE_AS_MODULE``), or is listed with a reason in
    ``RENAMED`` or ``JAX_ONLY``. A listed entry that is no longer needed
    fails, and so does a JAX name added without a counterpart."""
    surface = _jax_surface()
    assert len(surface) > 1500       # the scan sees the whole package
    assert _name_findings(surface, RENAMED, JAX_ONLY) == {
        "missing": [], "no_reason": [], "not_needed": []}


def test_every_jax_parameter_is_taken_by_the_port():
    """For each matched pair, every parameter of JAX's function or method
    is a parameter of the port's counterpart, or is listed with a reason
    in ``PARAM_RENAMED`` (whose name the port must take) or
    ``PARAM_JAX_ONLY``."""
    surface = _jax_surface()
    assert _param_findings(surface, PARAM_RENAMED, PARAM_JAX_ONLY) == {
        "missing": [], "no_reason": [], "not_needed": []}


@pytest.mark.parametrize("table", ["RENAMED", "JAX_ONLY", "PARAM_RENAMED",
                                   "PARAM_JAX_ONLY"])
def test_the_parity_tests_fail_on_a_removed_a_bare_or_a_stale_entry(table):
    """Each table's first entry taken out is reported missing, its
    reason emptied is reported, and an entry for a name JAX does not
    have is reported as no longer needed."""
    surface = _jax_surface()
    tables = {"RENAMED": dict(RENAMED), "JAX_ONLY": dict(JAX_ONLY),
              "PARAM_RENAMED": dict(PARAM_RENAMED),
              "PARAM_JAX_ONLY": dict(PARAM_JAX_ONLY)}
    names = table in ("RENAMED", "JAX_ONLY")
    findings = _name_findings if names else _param_findings

    def run():
        if names:
            return findings(surface, tables["RENAMED"], tables["JAX_ONLY"])
        return findings(surface, tables["PARAM_RENAMED"],
                        tables["PARAM_JAX_ONLY"])

    edited = tables[table]
    first, value = next(iter(edited.items()))
    del edited[first]
    assert first in run()["missing"]
    edited[first] = (value[0], " ") if isinstance(value, tuple) else " "
    assert run()["no_reason"] == [first]
    edited[first] = value
    stale = ("ops/rope.py:no_such_name" if names
             else "ops/rope.py:apply_rope:no_such_parameter")
    edited[stale] = ("x", "a reason") if isinstance(value, tuple) \
        else "a reason"
    assert run() == {"missing": [], "no_reason": [], "not_needed": [stale]}
