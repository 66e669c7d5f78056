"""Checkpoint/resume of a parameter tree (the port's copy of
``gofr_tpu/checkpoint.py``), in the JAX package's on-disk format, so
that a checkpoint written by either package restores in the other.

Format: one directory per step (``step_<n>/``) holding ``arrays.npz``
(the leaves as ``leaf_<i>``) and ``manifest.json`` (``step``,
``saved_at``, ``metadata``, ``treedef``, and per leaf its ``key``,
``name``, ``dtype`` and ``shape``). Leaves are in JAX's flattening
order (dict keys sorted, sequences in order) and keyed as
``jax.tree_util.keystr`` keys them (``"['layers']['wq']"``, ``"[0]"``).
bf16 leaves are stored as their raw ``uint16`` bits with ``"dtype":
"bfloat16"`` and read back through ``int16`` views, never through
float32. ``treedef`` holds JAX's repr in a JAX checkpoint; the port
writes its own description there, which neither package parses. A save
writes a ``.tmp_save_*`` directory and renames it into place, so a
crash mid-save never publishes a step; ``keep`` garbage-collects old
steps.

Quantized trees (the port's ``[N, K]`` codes, packed int4, float32
scales) round-trip within the port; only unquantized trees are
interchangeable with the JAX package's, whose quantized layout differs.

:func:`warm_start` is the counterpart of the JAX package's ``on_start``
hook: restore the latest step, build the engine from the nested tree and
start it, before the server takes traffic.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import struct
import tempfile
import time
import zipfile
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from .device import resolve_device

_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|-?\d+)\]")
MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
#: what the port writes under ``treedef`` (JAX writes its treedef repr)
TREEDEF = "gofr_tpu_torch: nested dicts (keys sorted) and lists; see keys"


class CheckpointError(Exception):
    pass


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in JAX's order: dict keys sorted, lists
    and tuples in order, named tuples (optax's states) by field
    (``.mu``), a train state's three children as JAX keys a pytree node
    registered without keys (``[<flat index i>]``), ``None`` an empty
    subtree."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += flatten(tree[key], f"{prefix}[{key!r}]")
        return out
    if hasattr(tree, "tree_children"):
        out = []
        for i, item in enumerate(tree.tree_children()):
            out += flatten(item, f"{prefix}[<flat index {i}>]")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += flatten(getattr(tree, name), f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += flatten(item, f"{prefix}[{i}]")
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _rebuild(like: Any, leaves: list) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` (an
    iterator) in :func:`flatten`'s order."""
    if isinstance(like, dict):
        out = {key: _rebuild(like[key], leaves) for key in sorted(like)}
        return {key: out[key] for key in like}
    if hasattr(like, "tree_children"):
        return type(like).from_children(
            [_rebuild(item, leaves) for item in like.tree_children()])
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(item, leaves) for item in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(item, leaves) for item in like)
    if like is None:
        return None
    return next(leaves)


def nest(flat: dict[str, Any]) -> Any:
    """The nested tree of a flat ``{keystr: leaf}`` dict (what
    :meth:`Checkpointer.restore` returns without ``like``): string keys
    become dicts, integer keys lists."""
    root: dict = {}
    for key, leaf in flat.items():
        parts = [ast.literal_eval(m) for m in _KEY_RE.findall(key)]
        if "".join(f"[{p!r}]" for p in parts) != key or not parts:
            raise CheckpointError(f"unreadable leaf key {key!r}")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node) \
                and sorted(node) == list(range(len(node))):
            return [node[i] for i in range(len(node))]
        return node

    return lists(root)


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype); bf16 as its raw uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return (leaf.view(torch.int16).cpu().numpy().view(np.uint16),
                    "bfloat16")
        array = leaf.cpu().numpy()
    else:
        array = np.asarray(leaf)
    return array, array.dtype.name


def _member(path: Path, name: str):
    """A memory map of the ``.npy`` member ``name`` of an uncompressed
    ``.npz`` (``np.savez``, both packages), or None if it is
    compressed: slicing it reads only the slice's pages."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(f"{name}.npy")
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            return None
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        if version not in ((1, 0), (2, 0)):
            return None
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if fortran or dtype.hasobject:
        return None
    return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                     shape=shape)


def _from_numpy(array: np.ndarray, dtype: str,
                device: torch.device | None) -> torch.Tensor:
    if dtype == "bfloat16":
        tensor = torch.from_numpy(np.asarray(array, order="C").view(
            np.int16)).view(torch.bfloat16)
    else:
        # order="C" keeps a 0-d leaf (a step, optax's count) 0-d, where
        # ascontiguousarray would make it 1-d
        tensor = torch.from_numpy(np.asarray(array, order="C"))
    return tensor.to(device) if device is not None else tensor


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3,
                 logger: Any = None) -> None:
        self.directory = Path(directory)
        self.keep = keep
        self.logger = logger
        self.directory.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any,
             metadata: dict | None = None) -> Path:
        """Write ``tree`` (nested dicts / lists of tensors, arrays or
        scalars, on any device) as step ``step``; a step already saved
        raises."""
        target = self.directory / f"step_{step}"
        if target.exists():
            raise CheckpointError(f"step {step} already saved")
        arrays: dict[str, np.ndarray] = {}
        manifest: dict[str, Any] = {
            "step": step,
            "saved_at": time.time(),
            "metadata": metadata or {},
            "treedef": TREEDEF,
            "leaves": [],
        }
        for i, (key, leaf) in enumerate(flatten(tree)):
            name = f"leaf_{i}"
            arrays[name], dtype = _to_numpy(leaf)
            manifest["leaves"].append(
                {"key": key, "name": name, "dtype": dtype,
                 "shape": list(arrays[name].shape)})

        tmp = Path(tempfile.mkdtemp(dir=self.directory, prefix=".tmp_save_"))
        try:
            with open(tmp / ARRAYS, "wb") as f:
                np.savez(f, **arrays)
            (tmp / MANIFEST).write_text(json.dumps(manifest))
            os.replace(tmp, target)  # atomic publish
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.logger is not None:
            self.logger.info(f"checkpoint saved step={step}",
                             path=str(target))
        self._gc()
        return target

    def _gc(self) -> None:
        steps = self.steps()
        for old in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.directory / f"step_{old}",
                          ignore_errors=True)

    # ------------------------------------------------------------ lookup
    def steps(self) -> list[int]:
        """Published steps, ascending (a directory without a manifest is
        an unfinished save, not a step)."""
        out = []
        for entry in self.directory.iterdir():
            match = _STEP_RE.match(entry.name)
            if match and (entry / MANIFEST).is_file():
                out.append(int(match.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int | None) -> tuple[int, dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.directory}")
        path = self.directory / f"step_{step}" / MANIFEST
        if not path.is_file():
            raise CheckpointError(f"missing checkpoint step {step}")
        return step, json.loads(path.read_text())

    # ----------------------------------------------------------- restore
    def restore(self, step: int | None = None, *, like: Any = None,
                device: str | torch.device | None = None,
                sharding_fn: Callable[[str], Any] | None = None) -> Any:
        """Load step ``step`` (default: the latest) as tensors.

        ``like``: a tree of the same structure (a freshly initialised
        one, a :class:`~gofr_tpu_torch.parallel.train.TrainState`); the
        leaves are rebuilt into it. Without it, a flat dict keyed by the
        leaves' keystr keys is returned, as the JAX package's
        ``restore`` returns (:func:`nest` makes it a tree). ``device``:
        each leaf is placed there as it is read (default: the host).
        ``sharding_fn(key) -> placement | None``: a leaf with a
        placement (``parallel.sharding.Sharding``: ``index(shape)`` and
        ``device``) is read as this rank's block only, through a memory
        map of its member, and placed on the placement's device.
        """
        step, manifest = self._manifest(step)
        dev = torch.device(device) if device is not None else None
        keys: list[str] = []
        leaves: list[torch.Tensor] = []
        path = self.directory / f"step_{step}" / ARRAYS
        with np.load(path) as data:
            for entry in manifest["leaves"]:
                keys.append(entry["key"])
                placement = (sharding_fn(entry["key"]) if sharding_fn
                             else None)
                if placement is None:
                    leaves.append(_from_numpy(data[entry["name"]],
                                              entry["dtype"], dev))
                    continue
                array = _member(path, entry["name"])
                if array is None:
                    array = data[entry["name"]]
                # a copy: the block must not stay a view of the map
                block = np.array(array[placement.index(array.shape)],
                                 order="C")
                leaves.append(_from_numpy(block, entry["dtype"],
                                          placement.device))
        if like is None:
            return dict(zip(keys, leaves))
        n_like = len(flatten(like))
        if n_like != len(leaves):
            raise CheckpointError(
                f"structure mismatch: checkpoint has {len(leaves)} leaves, "
                f"target has {n_like}")
        return _rebuild(like, iter(leaves))

    def restore_metadata(self, step: int | None = None) -> dict:
        return self._manifest(step)[1].get("metadata", {})


def warm_start(name: str, directory: str | Path,
               build_engine: Callable[[Any], Any], *,
               device: str | torch.device | None = None,
               logger: Any = None) -> Any:
    """Restore the latest checkpoint in ``directory`` onto ``device``
    (default: CUDA, or raise), build model ``name``'s engine from it with
    ``build_engine(params)`` and start it; returns the engine, for
    ``build_server``. Run it before the server takes traffic. No
    checkpoint raises :class:`CheckpointError` naming the model.

    ``build_engine`` gets the nested tree (``{"embed": ..., "layers":
    {...}}``), which ``llama_engine`` takes. The JAX package's hook hands
    it the flat keystr-keyed dict instead, and that engine's first
    request fails."""
    dev = resolve_device(device)
    checkpointer = Checkpointer(directory, logger=logger)
    step = checkpointer.latest_step()
    if step is None:
        raise CheckpointError(
            f"warm start of {name!r}: no checkpoint in {directory}")
    engine = build_engine(nest(checkpointer.restore(step, device=dev)))
    engine.start()
    if logger is not None:
        logger.info(f"warm-started {name} from step {step}")
    return engine


__all__ = ["ARRAYS", "MANIFEST", "CheckpointError", "Checkpointer",
           "flatten", "nest", "warm_start"]
