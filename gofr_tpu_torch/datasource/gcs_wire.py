"""Google Cloud Storage network client speaking the JSON API, plus a
mini server.

The reference's GCS module is a driver-backed network client
(datasource/file/gcs over cloud.google.com/go/storage). This client
speaks the storage JSON API directly — media upload
(``POST /upload/storage/v1/b/{bucket}/o?uploadType=media``), media
download (``?alt=media``), object list with ``items``/``nextPageToken``
pagination, delete — with Bearer-token auth, behind the same method
surface as the embedded
:class:`~gofr_tpu_torch.datasource.object_store.GCSFileSystem` adapter, so
swapping is a constructor change.

:class:`MiniGCSServer` serves those endpoints over the embedded
adapter on the framework's HTTP server and rejects requests whose
Bearer token doesn't match — auth failures look like real GCS (401).

The port's copy of ``gofr_tpu/datasource/gcs_wire.py``.
"""

from __future__ import annotations

import datetime as _dt
import json
import urllib.parse
import urllib.request
from typing import Any

from . import Instrumented
from .miniserver import ThreadedHTTPMiniServer
from .object_store import GCSFileSystem, ObjectNotFound, ObjectStoreEngine

# real GCS truncates listings at 1000 items per page
_PAGE_SIZE = 1000


class GCSError(Exception):
    pass


class GCSWire(Instrumented):
    """JSON-API client with the embedded adapter's verbs
    (upload/download/list_blobs, plus delete/exists)."""

    metric = "app_gcs_stats"
    log_tag = "GCS"

    def __init__(self, *, endpoint: str = "https://storage.googleapis.com",
                 bucket: str = "gofr", token: str = "",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.token = token
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to GCS", endpoint=self.endpoint,
                             bucket=self.bucket)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, method: str, path: str,
              body: bytes | None = None) -> tuple[int, bytes]:
        headers = {"Content-Type": "application/octet-stream"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(self.endpoint + path, data=body,
                                     method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    @staticmethod
    def _object_path(name: str) -> str:
        return urllib.parse.quote(name, safe="")

    # ----------------------------------------------------- native verbs
    def upload(self, name: str, data: bytes) -> None:
        def op():
            qs = urllib.parse.urlencode(
                {"uploadType": "media", "name": name})
            status, payload = self._call(
                "POST", f"/upload/storage/v1/b/{self.bucket}/o?{qs}",
                body=data)
            if status != 200:
                raise GCSError(f"upload {name} -> {status}: {payload[:200]!r}")
        self._observed("UPLOAD", name, op)

    def download(self, name: str) -> bytes:
        def op():
            status, payload = self._call(
                "GET", f"/storage/v1/b/{self.bucket}/o/"
                       f"{self._object_path(name)}?alt=media")
            if status == 404:
                raise ObjectNotFound(f"{self.bucket}/{name}")
            if status != 200:
                raise GCSError(
                    f"download {name} -> {status}: {payload[:200]!r}")
            return payload
        return self._observed("DOWNLOAD", name, op)

    def delete(self, name: str) -> None:
        def op():
            status, payload = self._call(
                "DELETE", f"/storage/v1/b/{self.bucket}/o/"
                          f"{self._object_path(name)}")
            if status == 404:
                raise ObjectNotFound(f"{self.bucket}/{name}")
            if status not in (200, 204):
                raise GCSError(f"delete {name} -> {status}: {payload[:200]!r}")
        self._observed("DELETE", name, op)

    def exists(self, name: str) -> bool:
        def op():
            status, payload = self._call(
                "GET", f"/storage/v1/b/{self.bucket}/o/"
                       f"{self._object_path(name)}")
            if status == 200:
                return True
            if status == 404:
                return False
            raise GCSError(f"stat {name} -> {status}: {payload[:200]!r}")
        return self._observed("STAT", name, op)

    def list_blobs(self, prefix: str = "") -> list[str]:
        def op():
            names: list[str] = []
            token = ""
            while True:  # follow nextPageToken to the end
                params = {"prefix": prefix}
                if token:
                    params["pageToken"] = token
                qs = urllib.parse.urlencode(params)
                status, payload = self._call(
                    "GET", f"/storage/v1/b/{self.bucket}/o?{qs}")
                if status != 200:
                    raise GCSError(f"list -> {status}: {payload[:200]!r}")
                data = json.loads(payload)
                names.extend(item["name"]
                             for item in data.get("items", []))
                token = data.get("nextPageToken", "")
                if not token:
                    return names
        return self._observed("LIST", prefix or "*", op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, _ = self._call("GET",
                                   f"/storage/v1/b/{self.bucket}/o")
            return {"status": "UP" if status == 200 else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "bucket": self.bucket}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

class MiniGCSServer(ThreadedHTTPMiniServer):
    """The storage JSON API over the embedded adapter. A configured
    ``token`` is enforced: a missing or wrong Bearer is a 401."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 token: str = "") -> None:
        super().__init__(host, port)
        self.token = token
        self.engine = ObjectStoreEngine()

    def handle(self, request) -> tuple[int, bytes, str]:
        if self.token:
            got = request.headers.get("authorization", "")
            if got != f"Bearer {self.token}":
                return 401, b'{"error": {"code": 401}}', "application/json"
        try:
            return self._route(request)
        except ObjectNotFound:
            return 404, b'{"error": {"code": 404}}', "application/json"

    def _route(self, request) -> tuple[int, bytes, str]:
        path = request.path
        if path.startswith("/upload/storage/v1/b/") \
                and request.method == "POST":
            bucket = path.split("/")[5]
            name = request.param("name")
            self.engine.put(bucket, name, request.body)
            return 200, json.dumps(
                {"name": name, "bucket": bucket,
                 "size": str(len(request.body))}).encode(), \
                "application/json"
        if path.startswith("/storage/v1/b/"):
            # the framework server hands the path already URL-decoded,
            # so the object name may contain real slashes — parse by
            # prefix, not by segment count
            rest = path[len("/storage/v1/b/"):]
            bucket, _, after = rest.partition("/o")
            if after in ("", "/"):
                return self._list(bucket, request)
            if after.startswith("/"):
                name = after[1:]
                if request.method == "GET" \
                        and request.param("alt") == "media":
                    return 200, self.engine.get(bucket, name), \
                        "application/octet-stream"
                if request.method == "GET":
                    data = self.engine.get(bucket, name)  # 404 when absent
                    return 200, json.dumps(
                        {"name": name, "bucket": bucket,
                         "size": str(len(data))}).encode(), \
                        "application/json"
                if request.method == "DELETE":
                    if not self.engine.exists(bucket, name):
                        raise ObjectNotFound(name)
                    self.engine.delete(bucket, name)
                    return 204, b"", "application/json"
        return 400, b'{"error": {"code": 400}}', "application/json"

    def _list(self, bucket: str, request) -> tuple[int, bytes, str]:
        prefix = request.param("prefix")
        token = request.param("pageToken")
        rows = sorted(self.engine.list(bucket, prefix))
        if token:  # opaque token = last name of the previous page
            rows = [r for r in rows if r[0] > token]
        page, rest = rows[:_PAGE_SIZE], rows[_PAGE_SIZE:]
        out: dict[str, Any] = {
            "kind": "storage#objects",
            "items": [{"name": k, "size": str(size),
                       "updated": _dt.datetime.fromtimestamp(
                           mtime, tz=_dt.timezone.utc).isoformat()}
                      for k, size, mtime in page]}
        if rest and page:
            out["nextPageToken"] = page[-1][0]
        return 200, json.dumps(out).encode(), "application/json"
