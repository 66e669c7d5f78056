"""S3 network client speaking the REST API with real AWS SigV4
signing, plus a signature-verifying mini server.

The reference's S3 module is a driver-backed network client
(datasource/file/s3 over aws-sdk-go). This client speaks the S3 REST
surface directly — PUT/GET/DELETE object, ListObjectsV2 (XML),
bucket creation — and signs every request with AWS Signature
Version 4 implemented from the specification (canonical request →
string-to-sign → HMAC chain), so it talks to real S3/MinIO/localstack
endpoints unchanged.

:class:`MiniS3Server` is the hermetic stand-in on the framework's own
HTTP server over the embedded
:class:`~gofr_tpu_torch.datasource.object_store.ObjectStoreEngine`. It
*verifies* each request's SigV4 signature against the configured
credentials — the tests prove the signing chain is real, not
decorative.

The port's copy of ``gofr_tpu/datasource/s3_wire.py``.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import threading
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Any

from . import Instrumented
from .miniserver import ThreadedHTTPMiniServer
from .object_store import ObjectNotFound, ObjectStoreEngine


class S3Error(Exception):
    pass


# ----------------------------------------------------------------- SigV4

def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, *, slash_ok: bool = False) -> str:
    safe = "-._~" + ("/" if slash_ok else "")
    return urllib.parse.quote(s, safe=safe)


def _canonical_query(query: dict[str, str]) -> str:
    """The one encoding both the signature and the URL must share —
    a single construction site so they byte-match by construction."""
    return "&".join(f"{_uri_encode(k)}={_uri_encode(v)}"
                    for k, v in sorted(query.items()))


def sign_v4(method: str, path: str, query: dict[str, str],
            headers: dict[str, str], payload: bytes, *,
            access_key: str, secret_key: str, region: str,
            service: str = "s3",
            when: _dt.datetime | None = None) -> dict[str, str]:
    """-> headers with Authorization/x-amz-date/x-amz-content-sha256
    added, per the SigV4 specification."""
    when = when or _dt.datetime.now(_dt.timezone.utc)
    amz_date = when.strftime("%Y%m%dT%H%M%SZ")
    scope_date = when.strftime("%Y%m%d")
    payload_hash = _sha256(payload)

    out = {k.lower(): v.strip() for k, v in headers.items()}
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash

    signed_names = sorted(out)
    canonical_headers = "".join(f"{k}:{out[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_query = _canonical_query(query)
    canonical_request = "\n".join([
        method, _uri_encode(path, slash_ok=True), canonical_query,
        canonical_headers, signed_headers, payload_hash])

    scope = f"{scope_date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        _sha256(canonical_request.encode())])

    key = _hmac(("AWS4" + secret_key).encode(), scope_date)
    key = _hmac(key, region)
    key = _hmac(key, service)
    key = _hmac(key, "aws4_request")
    signature = hmac.new(key, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()

    out["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return out


# ----------------------------------------------------------------- client

class S3Wire(Instrumented):
    """SigV4-signed S3 REST client with the embedded adapter's native
    verbs (put_object/get_object/delete_object/list_objects)."""

    metric = "app_s3_stats"
    log_tag = "S3"

    def __init__(self, *, endpoint: str = "http://localhost:9000",
                 bucket: str = "gofr", access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to S3", endpoint=self.endpoint,
                             bucket=self.bucket)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, method: str, path: str,
              query: dict[str, str] | None = None,
              body: bytes = b"") -> tuple[int, bytes]:
        query = query or {}
        host = urllib.parse.urlsplit(self.endpoint).netloc
        headers = sign_v4(method, path, query, {"host": host}, body,
                          access_key=self.access_key,
                          secret_key=self.secret_key, region=self.region)
        url = self.endpoint + _uri_encode(path, slash_ok=True)
        if query:
            url += "?" + _canonical_query(query)
        req = urllib.request.Request(url, data=body or None, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    # ----------------------------------------------------- native verbs
    def create_bucket(self, bucket: str | None = None) -> None:
        name = bucket or self.bucket
        # AWS requires a LocationConstraint body outside us-east-1
        body = b""
        if self.region != "us-east-1":
            body = (
                "<CreateBucketConfiguration>"
                f"<LocationConstraint>{self.region}</LocationConstraint>"
                "</CreateBucketConfiguration>").encode()

        def op():
            status, data = self._call("PUT", f"/{name}", body=body)
            if status not in (200, 409):
                raise S3Error(f"create bucket -> {status}: {data[:200]!r}")
        self._observed("CREATE_BUCKET", name, op)

    def put_object(self, key: str, body: bytes) -> None:
        def op():
            status, data = self._call(
                "PUT", f"/{self.bucket}/{key}", body=body)
            if status != 200:
                raise S3Error(f"put {key} -> {status}: {data[:200]!r}")
        self._observed("PUT", key, op)

    def get_object(self, key: str) -> bytes:
        def op():
            status, data = self._call("GET", f"/{self.bucket}/{key}")
            if status == 404:
                raise ObjectNotFound(f"{self.bucket}/{key}")
            if status != 200:
                raise S3Error(f"get {key} -> {status}: {data[:200]!r}")
            return data
        return self._observed("GET", key, op)

    def delete_object(self, key: str) -> None:
        def op():
            status, data = self._call("DELETE", f"/{self.bucket}/{key}")
            if status not in (200, 204):
                raise S3Error(f"delete {key} -> {status}: {data[:200]!r}")
        self._observed("DELETE", key, op)

    def list_objects(self, prefix: str = "") -> list[dict]:
        def op():
            out: list[dict] = []
            token = ""
            while True:  # follow ListObjectsV2 pagination to the end
                query = {"list-type": "2", "prefix": prefix}
                if token:
                    query["continuation-token"] = token
                status, data = self._call("GET", f"/{self.bucket}",
                                          query=query)
                if status != 200:
                    raise S3Error(f"list -> {status}: {data[:200]!r}")
                root = ET.fromstring(data)
                ns = (root.tag.partition("}")[0] + "}"
                      if "}" in root.tag else "")
                # same dict shape as the embedded
                # S3FileSystem.list_objects (object_store.py) so
                # backend swaps never break callers
                for item in root.iter(f"{ns}Contents"):
                    out.append({
                        "Key": item.findtext(f"{ns}Key", ""),
                        "Size": int(item.findtext(f"{ns}Size", "0")),
                        "LastModified": item.findtext(
                            f"{ns}LastModified", "")})
                if root.findtext(f"{ns}IsTruncated", "false") != "true":
                    return out
                token = root.findtext(f"{ns}NextContinuationToken", "")
                if not token:
                    return out
        return self._observed("LIST", prefix or "*", op)

    def exists(self, key: str) -> bool:
        def op():
            status, data = self._call("HEAD", f"/{self.bucket}/{key}")
            if status == 200:
                return True
            if status == 404:
                return False
            # 403/5xx are auth or server trouble, not "object absent"
            raise S3Error(f"head {key} -> {status}: {data[:200]!r}")
        return self._observed("HEAD", key, op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, _ = self._call("GET", f"/{self.bucket}",
                                   query={"list-type": "2",
                                          "max-keys": "0"})
            up = status in (200, 404)
            return {"status": "UP" if up else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "bucket": self.bucket}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

class MiniS3Server(ThreadedHTTPMiniServer):
    """S3 REST surface over the embedded ObjectStoreEngine, on the
    framework's HTTP server (lifecycle from
    :class:`~gofr_tpu_torch.datasource.miniserver.ThreadedHTTPMiniServer`).
    Every request's SigV4 signature is re-derived and verified against
    the configured credentials — a wrong secret is a 403, exactly like
    real S3."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 access_key: str = "test", secret_key: str = "secret",
                 region: str = "us-east-1") -> None:
        super().__init__(host, port)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.engine = ObjectStoreEngine()
        self.buckets: set[str] = set()
        self._lock = threading.Lock()

    def handle(self, request) -> tuple[int, bytes, str]:
        return self._route(request)

    # ----------------------------------------------------- verification
    def _verify(self, request) -> bool:
        auth = request.headers.get("authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        try:
            fields = dict(part.strip().split("=", 1)
                          for part in auth[17:].split(","))
            credential = fields["Credential"]
            signed_headers = fields["SignedHeaders"].split(";")
            got_signature = fields["Signature"]
            access_key, scope_date = credential.split("/")[:2]
        except (KeyError, ValueError):
            return False
        if access_key != self.access_key:
            return False
        headers = {name: request.headers.get(name, "")
                   for name in signed_headers}
        try:
            when = _dt.datetime.strptime(
                request.headers.get("x-amz-date", ""),
                "%Y%m%dT%H%M%SZ").replace(tzinfo=_dt.timezone.utc)
        except ValueError:  # missing/garbage date: bad auth, not a 500
            return False
        expect = sign_v4(
            request.method, request.path,
            {k: v[0] for k, v in request.query.items()},
            headers, request.body,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, when=when)
        expect_sig = expect["authorization"].rsplit("Signature=", 1)[-1]
        return hmac.compare_digest(expect_sig, got_signature)

    # ----------------------------------------------------------- routing
    def _route(self, request) -> tuple[int, bytes, str]:
        if not self._verify(request):
            return 403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>", \
                "application/xml"
        parts = request.path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        with self._lock:
            if request.method == "PUT" and not key:
                self.buckets.add(bucket)
                return 200, b"", "application/xml"
            if not key and request.method in ("GET", "HEAD"):
                return self._list(bucket, request)
            if request.method == "PUT":
                self.buckets.add(bucket)
                self.engine.put(bucket, key, request.body)
                return 200, b"", "application/xml"
            if request.method in ("GET", "HEAD"):
                try:
                    data = self.engine.get(bucket, key)
                except ObjectNotFound:
                    return 404, b"<Error><Code>NoSuchKey</Code></Error>", \
                        "application/xml"
                return 200, (b"" if request.method == "HEAD" else data), \
                    "application/octet-stream"
            if request.method == "DELETE":
                self.engine.delete(bucket, key)
                return 204, b"", "application/xml"
        return 400, b"<Error><Code>BadRequest</Code></Error>", \
            "application/xml"

    def _list(self, bucket: str, request) -> tuple[int, bytes, str]:
        prefix = request.param("prefix")
        max_keys = int(request.param("max-keys") or "1000")
        token = request.param("continuation-token")
        rows = sorted(self.engine.list(bucket, prefix))
        if token:  # opaque token = last key of the previous page
            rows = [r for r in rows if r[0] > token]
        page, rest = rows[:max_keys], rows[max_keys:]
        root = ET.Element("ListBucketResult")
        ET.SubElement(root, "Name").text = bucket
        for key, size, mtime in page:
            item = ET.SubElement(root, "Contents")
            ET.SubElement(item, "Key").text = key
            ET.SubElement(item, "Size").text = str(size)
            ET.SubElement(item, "LastModified").text = \
                _dt.datetime.fromtimestamp(
                    mtime, tz=_dt.timezone.utc).strftime(
                        "%Y-%m-%dT%H:%M:%S.000Z")
        ET.SubElement(root, "IsTruncated").text = \
            "true" if rest else "false"
        if rest and page:
            ET.SubElement(root, "NextContinuationToken").text = page[-1][0]
        return 200, ET.tostring(root), "application/xml"
