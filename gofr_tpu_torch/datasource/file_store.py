"""FileSystem abstraction + local implementation (the port's copy of
``gofr_tpu/datasource/file_store.py``).

The analog of reference ``datasource/file`` (interface.go:10-60,
local_fs.go, row_reader.go, observability.go:10-36): one interface over
local and remote stores (the reference ships azure/ftp/gcs/s3/sftp
behind it) so handler code is storage-agnostic. This build ships the
local FS; remote backends implement the same surface.

Ops are logged + timed into ``app_file_stats``; JSON/CSV row readers
mirror the reference's ``RowReader`` for line-oriented file parsing.
"""

from __future__ import annotations

import csv
import io
import json
import os
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator

from . import ProviderMixin


class FileError(Exception):
    pass


@dataclass
class FileInfo:
    """stat result (reference file/interface.go FileInfo)."""

    name: str
    size: int
    is_dir: bool
    mod_time: float


class RowReader:
    """Iterate structured rows out of a text payload
    (reference file/row_reader.go): JSON arrays/JSONL and CSV."""

    def __init__(self, text: str, kind: str) -> None:
        self._rows: list[Any] = []
        if kind == "json":
            stripped = text.strip()
            if stripped.startswith("["):
                self._rows = json.loads(stripped)
            else:
                self._rows = [json.loads(line)
                              for line in stripped.splitlines() if line.strip()]
        elif kind == "csv":
            self._rows = list(csv.DictReader(io.StringIO(text)))
        else:
            raise FileError(f"unsupported row format {kind!r}")

    def __iter__(self) -> Iterator[Any]:
        return iter(self._rows)

    def __len__(self) -> int:
        return len(self._rows)


class LocalFileSystem(ProviderMixin):
    """Local FS behind the FileSystem interface
    (reference file/local_fs.go)."""

    def __init__(self, root: str = ".") -> None:
        self.root = Path(root)

    def connect(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)

    def _observed(self, op: str, path: str, fn):
        start = time.perf_counter()
        status = "SUCCESS"
        try:
            return fn()
        except Exception:
            status = "ERROR"
            raise
        finally:
            micros = int((time.perf_counter() - start) * 1e6)
            if self.logger is not None:
                self.logger.debug(f"FILE {micros:6d}µs {op} {path} {status}")
            if self.metrics is not None:
                self.metrics.record_histogram("app_file_stats", micros / 1e6,
                                              type=op.lower(), status=status)

    def _resolve(self, path: str) -> Path:
        p = (self.root / path).resolve()
        root = self.root.resolve()
        if root != p and root not in p.parents:
            raise FileError(f"path escapes file-store root: {path!r}")
        return p

    # ------------------------------------------------------------- files
    def create(self, path: str, data: bytes | str = b"") -> None:
        def op():
            p = self._resolve(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            mode = "w" if isinstance(data, str) else "wb"
            with open(p, mode) as f:
                f.write(data)
        return self._observed("CREATE", path, op)

    def read(self, path: str) -> bytes:
        def op():
            return self._resolve(path).read_bytes()
        return self._observed("READ", path, op)

    def read_text(self, path: str) -> str:
        return self.read(path).decode()

    def append(self, path: str, data: bytes | str) -> None:
        def op():
            mode = "a" if isinstance(data, str) else "ab"
            with open(self._resolve(path), mode) as f:
                f.write(data)
        return self._observed("APPEND", path, op)

    def remove(self, path: str) -> None:
        def op():
            os.remove(self._resolve(path))
        return self._observed("REMOVE", path, op)

    def rename(self, old: str, new: str) -> None:
        def op():
            os.rename(self._resolve(old), self._resolve(new))
        return self._observed("RENAME", f"{old}->{new}", op)

    def stat(self, path: str) -> FileInfo:
        def op():
            p = self._resolve(path)
            st = p.stat()
            return FileInfo(name=p.name, size=st.st_size,
                            is_dir=p.is_dir(), mod_time=st.st_mtime)
        return self._observed("STAT", path, op)

    def exists(self, path: str) -> bool:
        return self._resolve(path).exists()

    # ------------------------------------------------------- directories
    def mkdir(self, path: str) -> None:
        def op():
            self._resolve(path).mkdir(parents=True, exist_ok=True)
        return self._observed("MKDIR", path, op)

    def remove_all(self, path: str) -> None:
        def op():
            shutil.rmtree(self._resolve(path))
        return self._observed("REMOVEALL", path, op)

    def read_dir(self, path: str = ".") -> list[FileInfo]:
        def op():
            out = []
            for child in sorted(self._resolve(path).iterdir()):
                st = child.stat()
                out.append(FileInfo(name=child.name, size=st.st_size,
                                    is_dir=child.is_dir(),
                                    mod_time=st.st_mtime))
            return out
        return self._observed("READDIR", path, op)

    def glob(self, pattern: str) -> list[str]:
        def op():
            root = self.root.resolve()
            return sorted(str(p.relative_to(root))
                          for p in root.glob(pattern))
        return self._observed("GLOB", pattern, op)

    # --------------------------------------------------------- row reads
    def read_rows(self, path: str, kind: str | None = None) -> RowReader:
        """Parse a JSON/JSONL/CSV file into rows
        (reference file/row_reader.go)."""
        if kind is None:
            suffix = Path(path).suffix.lower().lstrip(".")
            kind = {"jsonl": "json"}.get(suffix, suffix)
        return RowReader(self.read_text(path), kind)

    # ------------------------------------------------------------ health
    def health_check(self) -> dict[str, Any]:
        try:
            usage = shutil.disk_usage(self.root)
            return {"status": "UP",
                    "details": {"root": str(self.root),
                                "free_bytes": usage.free}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        pass
