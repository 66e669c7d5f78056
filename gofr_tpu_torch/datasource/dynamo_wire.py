"""DynamoDB network client speaking the JSON 1.0 API with SigV4
signing, plus a signature-verifying mini server.

The reference ships a DynamoDB-backed KV store module
(datasource/kv-store/dynamodb over aws-sdk-go). This client speaks the
service's wire surface directly — ``POST /`` with
``X-Amz-Target: DynamoDB_20120810.<Op>`` and
``application/x-amz-json-1.0`` bodies (GetItem/PutItem/DeleteItem/
Scan), signed with the same from-spec SigV4 chain the S3 client uses
(:func:`~gofr_tpu_torch.datasource.s3_wire.sign_v4`, ``service="dynamodb"``)
— behind the framework's KV surface (get/set/delete/keys), so it slots
into the container's ``kv`` slot interchangeably with
:class:`~gofr_tpu_torch.datasource.kv.InMemoryKV`.

:class:`MiniDynamoServer` verifies every request's SigV4 signature
against the configured credentials and serves the four targets over an
in-process table — a wrong secret is a 403, like real AWS.

The port's copy of ``gofr_tpu/datasource/dynamo_wire.py``.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import urllib.request
from typing import Any

from .kv import KeyNotFound, KVError, _Instrumented
from .miniserver import ThreadedHTTPMiniServer
from .s3_wire import sign_v4

_TARGET_PREFIX = "DynamoDB_20120810."
_CONTENT_TYPE = "application/x-amz-json-1.0"


class DynamoError(KVError):
    pass


class DynamoKV(_Instrumented):
    """SigV4-signed DynamoDB client behind the KV surface. String
    values live in attribute ``v`` under partition key ``k``; every op
    records into ``app_kv_stats`` like the other KV backends."""

    def __init__(self, *, endpoint: str = "https://dynamodb.us-east-1.amazonaws.com",
                 table: str = "gofr_kv", access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.table = table
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to dynamodb",
                             endpoint=self.endpoint, table=self.table)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, target: str, body: dict) -> tuple[int, dict]:
        payload = json.dumps(body).encode()
        host = urllib.parse.urlsplit(self.endpoint).netloc
        headers = sign_v4(
            "POST", "/", {},
            {"host": host, "x-amz-target": _TARGET_PREFIX + target,
             "content-type": _CONTENT_TYPE},
            payload, access_key=self.access_key,
            secret_key=self.secret_key, region=self.region,
            service="dynamodb")
        req = urllib.request.Request(self.endpoint + "/", data=payload,
                                     method="POST", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as exc:
            data = exc.read()
            try:
                return exc.code, json.loads(data or b"{}")
            except json.JSONDecodeError:
                return exc.code, {"message": data.decode("utf-8", "replace")}

    def _checked(self, target: str, body: dict) -> dict:
        status, data = self._call(target, body)
        if status != 200:
            raise DynamoError(
                f"{target} -> {status}: {data.get('message', data)}")
        return data

    # --------------------------------------------------------- KV verbs
    def get(self, key: str) -> str:
        def op():
            data = self._checked("GetItem", {
                "TableName": self.table,
                "Key": {"k": {"S": key}}, "ConsistentRead": True})
            item = data.get("Item")
            if not item:
                raise KeyNotFound(key)
            return item["v"]["S"]
        return self._observed("GET", key, op)

    def set(self, key: str, value: str) -> None:
        def op():
            self._checked("PutItem", {
                "TableName": self.table,
                "Item": {"k": {"S": key}, "v": {"S": str(value)}}})
        self._observed("SET", key, op)

    def delete(self, key: str) -> None:
        # idempotent like the other KV backends: deleting an absent
        # key is a no-op, not an error
        def op():
            self._checked("DeleteItem", {
                "TableName": self.table, "Key": {"k": {"S": key}}})
        self._observed("DELETE", key, op)

    def keys(self) -> list[str]:
        def op():
            out: list[str] = []
            start: dict | None = None
            while True:  # follow LastEvaluatedKey pagination to the end
                body: dict[str, Any] = {"TableName": self.table,
                                        "ProjectionExpression": "k"}
                if start:
                    body["ExclusiveStartKey"] = start
                data = self._checked("Scan", body)
                out.extend(item["k"]["S"]
                           for item in data.get("Items", []))
                start = data.get("LastEvaluatedKey")
                if not start:
                    return sorted(out)
        return self._observed("KEYS", "*", op)

    def health_check(self) -> dict[str, Any]:
        try:
            self._checked("Scan", {"TableName": self.table, "Limit": 1})
            return {"status": "UP",
                    "details": {"endpoint": self.endpoint,
                                "table": self.table}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

# real DynamoDB pages Scan responses at 1MB; the mini server pages by
# item count so the client's pagination loop is exercised
_SCAN_PAGE = 1000


class MiniDynamoServer(ThreadedHTTPMiniServer):
    """The four DynamoDB targets over an in-process table, with SigV4
    verification against the configured credentials."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 access_key: str = "test", secret_key: str = "secret",
                 region: str = "us-east-1") -> None:
        super().__init__(host, port)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.tables: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()

    def _verify(self, request) -> bool:
        import datetime as _dt
        import hmac as _hmac
        auth = request.headers.get("authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        try:
            fields = dict(part.strip().split("=", 1)
                          for part in auth[17:].split(","))
            signed_headers = fields["SignedHeaders"].split(";")
            got_signature = fields["Signature"]
            access_key = fields["Credential"].split("/")[0]
            when = _dt.datetime.strptime(
                request.headers.get("x-amz-date", ""),
                "%Y%m%dT%H%M%SZ").replace(tzinfo=_dt.timezone.utc)
        except (KeyError, ValueError):
            return False
        if access_key != self.access_key:
            return False
        headers = {name: request.headers.get(name, "")
                   for name in signed_headers}
        expect = sign_v4("POST", request.path,
                         {k: v[0] for k, v in request.query.items()},
                         headers, request.body,
                         access_key=self.access_key,
                         secret_key=self.secret_key, region=self.region,
                         service="dynamodb", when=when)
        expect_sig = expect["authorization"].rsplit("Signature=", 1)[-1]
        return _hmac.compare_digest(expect_sig, got_signature)

    def handle(self, request) -> tuple[int, bytes, str]:
        if not self._verify(request):
            return 403, json.dumps(
                {"__type": "InvalidSignatureException",
                 "message": "signature mismatch"}).encode(), _CONTENT_TYPE
        target = request.headers.get("x-amz-target", "")
        if not target.startswith(_TARGET_PREFIX):
            return 400, b'{"message": "bad target"}', _CONTENT_TYPE
        op = target[len(_TARGET_PREFIX):]
        body = json.loads(request.body or b"{}")
        table = self.tables.setdefault(body.get("TableName", ""), {})
        with self._lock:
            if op == "PutItem":
                item = body["Item"]
                table[item["k"]["S"]] = item
                return 200, b"{}", _CONTENT_TYPE
            if op == "GetItem":
                item = table.get(body["Key"]["k"]["S"])
                out = {"Item": item} if item else {}
                return 200, json.dumps(out).encode(), _CONTENT_TYPE
            if op == "DeleteItem":
                item = table.pop(body["Key"]["k"]["S"], None)
                out = {"Attributes": item} if item else {}
                return 200, json.dumps(out).encode(), _CONTENT_TYPE
            if op == "Scan":
                rows = sorted(table.items())
                start = body.get("ExclusiveStartKey")
                if start:
                    after = start["k"]["S"]
                    rows = [r for r in rows if r[0] > after]
                limit = min(int(body.get("Limit", _SCAN_PAGE)), _SCAN_PAGE)
                page, rest = rows[:limit], rows[limit:]
                out = {"Items": [item for _, item in page],
                       "Count": len(page)}
                if rest and page:
                    out["LastEvaluatedKey"] = {"k": {"S": page[-1][0]}}
                return 200, json.dumps(out).encode(), _CONTENT_TYPE
        return 400, json.dumps(
            {"message": f"unsupported op {op}"}).encode(), _CONTENT_TYPE
