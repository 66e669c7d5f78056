"""Remote file stores: S3-, GCS- and Azure-Blob-shaped filesystems
behind the same ``FileSystem`` interface as the local store.

The reference ships azure/ftp/gcs/s3/sftp modules that all implement
one ``FileSystem`` interface (datasource/interface.go:10-60, modules
datasource/file/{azure,ftp,gcs,s3,sftp}); handlers call ``ctx.file``
the same way regardless of backend. Here each cloud store is an
adapter over :class:`ObjectStoreEngine` — an embedded bucket/key →
bytes engine with object-store semantics (no real directories; key
prefixes emulate them) — exposing BOTH the generic FileSystem surface
(create/read/read_dir/...) and the store's native verbs
(put_object/get_object/list_objects for S3, upload/download blobs for
Azure, ...). A production deployment swaps the engine for a network
client behind the same adapter.

The port's copy of ``gofr_tpu/datasource/object_store.py``.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Any

from . import Instrumented
from .file_store import FileError, FileInfo, RowReader


class ObjectNotFound(FileError):
    pass


class ObjectStoreEngine:
    """Embedded bucket/key->bytes store with list-by-prefix."""

    def __init__(self) -> None:
        self._buckets: dict[str, dict[str, tuple[bytes, float]]] = {}
        self._lock = threading.RLock()

    def put(self, bucket: str, key: str, data: bytes) -> None:
        with self._lock:
            self._buckets.setdefault(bucket, {})[key] = (data, time.time())

    def get(self, bucket: str, key: str) -> bytes:
        with self._lock:
            objects = self._buckets.get(bucket, {})
            if key not in objects:
                raise ObjectNotFound(f"{bucket}/{key}")
            return objects[key][0]

    def delete(self, bucket: str, key: str) -> bool:
        with self._lock:
            return self._buckets.get(bucket, {}).pop(key, None) is not None

    def list(self, bucket: str, prefix: str = "") -> list[tuple[str, int, float]]:
        with self._lock:
            objects = self._buckets.get(bucket, {})
            return sorted((k, len(v[0]), v[1]) for k, v in objects.items()
                          if k.startswith(prefix))

    def exists(self, bucket: str, key: str) -> bool:
        with self._lock:
            return key in self._buckets.get(bucket, {})

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"buckets": len(self._buckets),
                    "objects": sum(len(b) for b in self._buckets.values())}


class _ObjectFileSystem(Instrumented):
    """Generic FileSystem surface over one bucket of the engine."""

    backend_name = "object"
    metric = "app_file_stats"
    log_tag = "OBJ"

    def __init__(self, bucket: str,
                 engine: ObjectStoreEngine | None = None) -> None:
        self.bucket = bucket
        self.engine = engine if engine is not None else ObjectStoreEngine()

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.debug(f"connected {self.backend_name} store",
                              bucket=self.bucket)

    @staticmethod
    def _norm(path: str) -> str:
        return path.lstrip("./").lstrip("/")

    # -- FileSystem surface (matches datasource/file_store.py)
    def create(self, path: str, data: bytes | str = b"") -> None:
        payload = data.encode() if isinstance(data, str) else bytes(data)
        self._observed("CREATE", path, lambda: self.engine.put(
            self.bucket, self._norm(path), payload))

    def read(self, path: str) -> bytes:
        return self._observed("READ", path, lambda: self.engine.get(
            self.bucket, self._norm(path)))

    def read_text(self, path: str) -> str:
        return self.read(path).decode()

    def append(self, path: str, data: bytes | str) -> None:
        payload = data.encode() if isinstance(data, str) else bytes(data)
        def op():
            key = self._norm(path)
            try:
                existing = self.engine.get(self.bucket, key)
            except ObjectNotFound:
                existing = b""
            self.engine.put(self.bucket, key, existing + payload)
        self._observed("APPEND", path, op)

    def remove(self, path: str) -> None:
        def op():
            if not self.engine.delete(self.bucket, self._norm(path)):
                raise ObjectNotFound(f"{self.bucket}/{path}")
        self._observed("REMOVE", path, op)

    def rename(self, old: str, new: str) -> None:
        def op():
            data = self.engine.get(self.bucket, self._norm(old))
            self.engine.put(self.bucket, self._norm(new), data)
            self.engine.delete(self.bucket, self._norm(old))
        self._observed("RENAME", f"{old}->{new}", op)

    def stat(self, path: str) -> FileInfo:
        def op():
            key = self._norm(path)
            for k, size, mtime in self.engine.list(self.bucket, key):
                if k == key:
                    return FileInfo(name=key.rsplit("/", 1)[-1], size=size,
                                    mod_time=mtime, is_dir=False)
            raise ObjectNotFound(f"{self.bucket}/{path}")
        return self._observed("STAT", path, op)

    def exists(self, path: str) -> bool:
        return self.engine.exists(self.bucket, self._norm(path))

    def mkdir(self, path: str) -> None:
        # object stores have no directories; prefixes appear on write
        pass

    def remove_all(self, path: str) -> None:
        def op():
            prefix = self._norm(path).rstrip("/")
            for key, _, _ in self.engine.list(self.bucket,
                                              prefix + "/" if prefix else ""):
                self.engine.delete(self.bucket, key)
            self.engine.delete(self.bucket, prefix)
        self._observed("REMOVE_ALL", path, op)

    def read_dir(self, path: str = ".") -> list[FileInfo]:
        def op():
            prefix = self._norm(path if path != "." else "")
            if prefix and not prefix.endswith("/"):
                prefix += "/"
            seen_dirs: set[str] = set()
            out: list[FileInfo] = []
            for key, size, mtime in self.engine.list(self.bucket, prefix):
                rest = key[len(prefix):]
                if "/" in rest:  # emulate one directory level
                    top = rest.split("/", 1)[0]
                    if top not in seen_dirs:
                        seen_dirs.add(top)
                        out.append(FileInfo(name=top, size=0,
                                            mod_time=mtime, is_dir=True))
                else:
                    out.append(FileInfo(name=rest, size=size,
                                        mod_time=mtime, is_dir=False))
            return out
        return self._observed("READ_DIR", path, op)

    def glob(self, pattern: str) -> list[str]:
        return [key for key, _, _ in self.engine.list(self.bucket)
                if fnmatch.fnmatch(key, self._norm(pattern))]

    def read_rows(self, path: str, kind: str | None = None) -> RowReader:
        text = self.read_text(path)
        if kind is None:
            kind = "csv" if path.endswith(".csv") else "json"
        return RowReader(text, kind)

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP",
                "details": {"backend": self.backend_name,
                            "bucket": self.bucket,
                            **self.engine.stats()}}

    def close(self) -> None:
        pass


class S3FileSystem(_ObjectFileSystem):
    """S3-shaped store (reference datasource/file/s3): the FileSystem
    surface plus native object verbs."""

    backend_name = "s3"
    log_tag = "S3"

    def put_object(self, key: str, body: bytes) -> None:
        self.create(key, body)

    def get_object(self, key: str) -> bytes:
        return self.read(key)

    def delete_object(self, key: str) -> None:
        self.remove(key)

    def list_objects(self, prefix: str = "") -> list[dict]:
        return [{"Key": k, "Size": size,
                 "LastModified": mtime}
                for k, size, mtime in self.engine.list(self.bucket, prefix)]


class GCSFileSystem(_ObjectFileSystem):
    """GCS-shaped store (reference datasource/file/gcs)."""

    backend_name = "gcs"
    log_tag = "GCS"

    def upload(self, name: str, data: bytes) -> None:
        self.create(name, data)

    def download(self, name: str) -> bytes:
        return self.read(name)

    def list_blobs(self, prefix: str = "") -> list[str]:
        return [k for k, _, _ in self.engine.list(self.bucket, prefix)]


class AzureBlobFileSystem(_ObjectFileSystem):
    """Azure-Blob-shaped store (reference datasource/file/azure);
    ``bucket`` is the container."""

    backend_name = "azure"
    log_tag = "AZBLOB"

    def upload_blob(self, name: str, data: bytes,
                    overwrite: bool = True) -> None:
        if not overwrite and self.exists(name):
            raise FileError(f"blob exists: {name}")
        self.create(name, data)

    def download_blob(self, name: str) -> bytes:
        return self.read(name)

    def delete_blob(self, name: str) -> None:
        self.remove(name)

    def list_blob_names(self, prefix: str = "") -> list[str]:
        return [k for k, _, _ in self.engine.list(self.bucket, prefix)]
