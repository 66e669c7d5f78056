"""Azure Blob Storage network client speaking the Blob REST API with
real SharedKey request signing, plus a signature-verifying mini server.

The reference's Azure module is a driver-backed network client
(datasource/file/azure over azure-sdk-for-go). This client speaks the
Blob service REST surface directly — ``PUT`` block blobs, ``GET``/
``DELETE`` blobs, container listing with ``NextMarker`` pagination —
and signs every request with the SharedKey scheme implemented from the
specification (canonicalized x-ms-* headers + canonicalized resource →
HMAC-SHA256 with the base64 account key), behind the same method
surface as the embedded
:class:`~gofr_tpu_torch.datasource.object_store.AzureBlobFileSystem`
adapter, so swapping is a constructor change.

:class:`MiniAzureBlobServer` re-derives and verifies each request's
SharedKey signature against the configured account key — a wrong key
is a 403, exactly like real Azure.

The port's copy of ``gofr_tpu/datasource/azure_blob_wire.py``.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import hmac
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Any

from . import Instrumented
from .miniserver import ThreadedHTTPMiniServer
from .object_store import FileError, ObjectNotFound, ObjectStoreEngine

_API_VERSION = "2021-08-06"
# real Azure truncates listings at 5000 blobs per page
_PAGE_SIZE = 5000


class AzureBlobError(FileError):
    pass


def sign_shared_key(method: str, path: str, query: dict[str, str],
                    headers: dict[str, str], *, account: str,
                    key_b64: str) -> str:
    """-> the ``SharedKey account:signature`` Authorization value, per
    the Blob service authorization specification."""
    h = {k.lower(): v.strip() for k, v in headers.items()}
    get = h.get
    canonical_headers = "".join(
        f"{name}:{h[name]}\n"
        for name in sorted(n for n in h if n.startswith("x-ms-")))
    canonical_resource = f"/{account}{path}"
    for name in sorted(query):
        canonical_resource += f"\n{name.lower()}:{query[name]}"
    string_to_sign = "\n".join([
        method.upper(),
        get("content-encoding", ""), get("content-language", ""),
        get("content-length", ""), get("content-md5", ""),
        get("content-type", ""), get("date", ""),
        get("if-modified-since", ""), get("if-match", ""),
        get("if-none-match", ""), get("if-unmodified-since", ""),
        get("range", ""),
    ]) + "\n" + canonical_headers + canonical_resource
    digest = hmac.new(base64.b64decode(key_b64), string_to_sign.encode(),
                      hashlib.sha256).digest()
    return f"SharedKey {account}:{base64.b64encode(digest).decode()}"


class AzureBlobWire(Instrumented):
    """SharedKey-signed REST client with the embedded adapter's verbs
    (upload_blob/download_blob/delete_blob/list_blob_names)."""

    metric = "app_azure_blob_stats"
    log_tag = "AZBLOB"

    def __init__(self, *, endpoint: str = "", account: str = "devaccount",
                 key_b64: str = "", container: str = "gofr",
                 timeout_s: float = 30.0) -> None:
        endpoint = endpoint or f"https://{account}.blob.core.windows.net"
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.account = account
        self.key_b64 = key_b64
        self.container = container
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to azure blob",
                             endpoint=self.endpoint,
                             container=self.container)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, method: str, path: str, query: dict[str, str],
              body: bytes = b"",
              extra_headers: dict[str, str] | None = None
              ) -> tuple[int, bytes]:
        now = _dt.datetime.now(_dt.timezone.utc).strftime(
            "%a, %d %b %Y %H:%M:%S GMT")
        # Content-Type must be set explicitly: urllib would otherwise
        # inject its form-encoded default AFTER signing, and the server
        # (which signs what it received) would compute a different MAC
        headers = {"x-ms-date": now, "x-ms-version": _API_VERSION,
                   "Content-Type": "application/octet-stream"}
        headers.update(extra_headers or {})
        # post-2015 API versions sign an EMPTY Content-Length for 0
        headers["Content-Length"] = str(len(body)) if body else ""
        headers["Authorization"] = sign_shared_key(
            method, path, query, headers,
            account=self.account, key_b64=self.key_b64)
        if not body:
            del headers["Content-Length"]  # urllib sets the real one
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(url, data=body or None, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    def _blob_path(self, name: str) -> str:
        return f"/{self.container}/{name}"

    # ----------------------------------------------------- native verbs
    def upload_blob(self, name: str, data: bytes,
                    overwrite: bool = True) -> None:
        def op():
            extra = {"x-ms-blob-type": "BlockBlob"}
            if not overwrite:
                extra["If-None-Match"] = "*"
            status, payload = self._call("PUT", self._blob_path(name), {},
                                         body=data, extra_headers=extra)
            if status == 409 or (status == 412 and not overwrite):
                raise AzureBlobError(f"blob exists: {name}")
            if status != 201:
                raise AzureBlobError(
                    f"upload {name} -> {status}: {payload[:200]!r}")
        self._observed("UPLOAD", name, op)

    def download_blob(self, name: str) -> bytes:
        def op():
            status, payload = self._call("GET", self._blob_path(name), {})
            if status == 404:
                raise ObjectNotFound(f"{self.container}/{name}")
            if status != 200:
                raise AzureBlobError(
                    f"download {name} -> {status}: {payload[:200]!r}")
            return payload
        return self._observed("DOWNLOAD", name, op)

    def delete_blob(self, name: str) -> None:
        def op():
            status, payload = self._call("DELETE", self._blob_path(name), {})
            if status == 404:
                raise ObjectNotFound(f"{self.container}/{name}")
            if status not in (200, 202):
                raise AzureBlobError(
                    f"delete {name} -> {status}: {payload[:200]!r}")
        self._observed("DELETE", name, op)

    def list_blob_names(self, prefix: str = "") -> list[str]:
        def op():
            names: list[str] = []
            marker = ""
            while True:  # follow NextMarker pagination to the end
                query = {"restype": "container", "comp": "list",
                         "prefix": prefix}
                if marker:
                    query["marker"] = marker
                status, payload = self._call(
                    "GET", f"/{self.container}", query)
                if status != 200:
                    raise AzureBlobError(
                        f"list -> {status}: {payload[:200]!r}")
                root = ET.fromstring(payload)
                for blob in root.iter("Blob"):
                    names.append(blob.findtext("Name", ""))
                marker = root.findtext("NextMarker") or ""
                if not marker:
                    return names
        return self._observed("LIST", prefix or "*", op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, _ = self._call(
                "GET", f"/{self.container}",
                {"restype": "container", "comp": "list", "prefix": ""})
            return {"status": "UP" if status == 200 else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "container": self.container}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

class MiniAzureBlobServer(ThreadedHTTPMiniServer):
    """The Blob REST surface over the embedded engine. Every request's
    SharedKey signature is re-derived and verified against the account
    key — a wrong key is a 403, like real Azure."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 account: str = "devaccount",
                 key_b64: str = "") -> None:
        super().__init__(host, port)
        self.account = account
        self.key_b64 = key_b64 or base64.b64encode(b"mini-key").decode()
        self.engine = ObjectStoreEngine()

    def _verify(self, request) -> bool:
        got = request.headers.get("authorization", "")
        headers = {name: value for name, value in request.headers.items()}
        body = request.body or b""
        headers["content-length"] = str(len(body)) if body else ""
        expect = sign_shared_key(
            request.method, request.path,
            {k: v[0] for k, v in request.query.items()},
            headers, account=self.account, key_b64=self.key_b64)
        return hmac.compare_digest(got, expect)

    def handle(self, request) -> tuple[int, bytes, str]:
        if not self._verify(request):
            return 403, (b"<Error><Code>AuthenticationFailed</Code>"
                         b"</Error>"), "application/xml"
        parts = request.path.lstrip("/").split("/", 1)
        container = parts[0]
        name = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        if not name and request.param("comp") == "list":
            return self._list(container, request)
        if request.method == "PUT":
            if request.headers.get("if-none-match") == "*" \
                    and self.engine.exists(container, name):
                return 412, (b"<Error><Code>BlobAlreadyExists</Code>"
                             b"</Error>"), "application/xml"
            self.engine.put(container, name, request.body)
            return 201, b"", "application/xml"
        if request.method == "GET":
            try:
                data = self.engine.get(container, name)
            except ObjectNotFound:
                return 404, (b"<Error><Code>BlobNotFound</Code></Error>"), \
                    "application/xml"
            return 200, data, "application/octet-stream"
        if request.method == "DELETE":
            if not self.engine.exists(container, name):
                return 404, (b"<Error><Code>BlobNotFound</Code></Error>"), \
                    "application/xml"
            self.engine.delete(container, name)
            return 202, b"", "application/xml"
        return 400, b"<Error><Code>BadRequest</Code></Error>", \
            "application/xml"

    def _list(self, container: str, request) -> tuple[int, bytes, str]:
        prefix = request.param("prefix")
        marker = request.param("marker")
        rows = sorted(self.engine.list(container, prefix))
        if marker:  # opaque marker = last name of the previous page
            rows = [r for r in rows if r[0] > marker]
        page, rest = rows[:_PAGE_SIZE], rows[_PAGE_SIZE:]
        root = ET.Element("EnumerationResults")
        blobs = ET.SubElement(root, "Blobs")
        for key, size, _mtime in page:
            blob = ET.SubElement(blobs, "Blob")
            ET.SubElement(blob, "Name").text = key
            props = ET.SubElement(blob, "Properties")
            ET.SubElement(props, "Content-Length").text = str(size)
        if rest and page:
            ET.SubElement(root, "NextMarker").text = page[-1][0]
        return 200, ET.tostring(root), "application/xml"
