"""InfluxDB network client speaking the 1.x HTTP API (line protocol
writes, InfluxQL queries), plus a mini server.

The reference's InfluxDB module is a driver-backed network client
(container/datasources.go:797-839). This client speaks the database's
HTTP wire surface directly — ``POST /write?db=`` with line protocol,
``GET /query?q=`` returning the ``results/series`` JSON — behind the
same method surface as the embedded
:class:`~gofr_tpu_torch.datasource.timeseries.InfluxDB` adapter, so swapping
is a constructor change. Buckets map to databases (the 1.x name for
the same concept).

:class:`MiniInfluxServer` implements the same HTTP surface over the
embedded :class:`~gofr_tpu_torch.datasource.timeseries.SeriesEngine` on the
framework's own HTTP server — hermetic wire tests, real bytes.

The port's copy of ``gofr_tpu/datasource/influx_wire.py``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request
from typing import Any

from . import Instrumented
from .miniserver import ThreadedHTTPMiniServer
from .timeseries import SeriesEngine, TimeseriesError


# ----------------------------------------------------------- line protocol

def escape_tag(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace(",", "\\,") \
        .replace(" ", "\\ ").replace("=", "\\=")


def escape_measurement(value: str) -> str:
    # measurements only escape ',' and ' ' — '=' is literal here
    return str(value).replace("\\", "\\\\").replace(",", "\\,") \
        .replace(" ", "\\ ")


def encode_line(measurement: str, fields: dict[str, float],
                tags: dict | None = None, ts: float | None = None) -> str:
    """One line-protocol record: ``m,tag=v field=1.5 <ns>``."""
    if not fields:
        raise TimeseriesError("at least one field required")
    parts = [escape_measurement(measurement)]
    for key in sorted(tags or {}):
        parts.append(f"{escape_tag(key)}={escape_tag((tags or {})[key])}")
    head = ",".join(parts)
    body = ",".join(f"{escape_tag(k)}={float(v)}"
                    for k, v in sorted(fields.items()))
    line = f"{head} {body}"
    if ts is not None:
        line += f" {int(ts * 1e9)}"
    return line


#: placeholders for escaped separators so plain str.split works on the
#: unescaped ones, then tokens unescape individually
_ESCAPES = (("\\\\", "\x01"), ("\\ ", "\x02"), ("\\,", "\x03"),
            ("\\=", "\x04"))


def _unescape(token: str) -> str:
    for seq, mark in _ESCAPES:
        token = token.replace(mark, seq[1])
    return token


def decode_line(line: str) -> tuple[str, dict, dict, float | None]:
    """-> (measurement, tags, fields, ts_seconds|None)."""
    s = line.strip()
    for seq, mark in _ESCAPES:
        s = s.replace(seq, mark)
    chunks = [c for c in s.split(" ") if c]
    if len(chunks) < 2:
        raise TimeseriesError(f"bad line: {line!r}")
    head, field_part = chunks[0], chunks[1]
    ts = int(chunks[2]) / 1e9 if len(chunks) > 2 else None
    head_parts = head.split(",")
    measurement = _unescape(head_parts[0])
    tags = {}
    for tag in head_parts[1:]:
        k, _, v = tag.partition("=")
        tags[_unescape(k)] = _unescape(v)
    fields = {}
    for fv in field_part.split(","):
        k, _, v = fv.partition("=")
        fields[_unescape(k)] = float(v.rstrip("i"))
    return measurement, tags, fields, ts


# ----------------------------------------------------------------- client

class InfluxWire(Instrumented):
    """HTTP/line-protocol client with the embedded adapter's surface.
    Shares the embedded adapter's ``app_influxdb_stats`` series."""

    metric = "app_influxdb_stats"
    log_tag = "INFLUX"

    def __init__(self, *, url: str = "http://localhost:8086",
                 timeout_s: float = 10.0) -> None:
        if "://" not in url:
            url = "http://" + url
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to InfluxDB", url=self.url)

    def close(self) -> None:
        pass  # connections are per-request

    def _post(self, path: str, body: bytes,
              content_type: str = "text/plain") -> bytes:
        req = urllib.request.Request(
            self.url + path, data=body,
            headers={"Content-Type": content_type})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.read()
        except urllib.error.HTTPError as exc:
            raise TimeseriesError(
                f"{path} -> {exc.code}: {exc.read()[:200]!r}") from exc

    def _get(self, path: str) -> dict:
        try:
            with urllib.request.urlopen(self.url + path,
                                        timeout=self.timeout_s) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as exc:
            raise TimeseriesError(
                f"{path} -> {exc.code}: {exc.read()[:200]!r}") from exc

    # ----------------------------------------------------------- surface
    @staticmethod
    def _ident(name: str) -> str:
        """Double-quoted InfluxQL identifier; embedded '"' cannot be
        escaped portably, so reject it outright."""
        if '"' in name or "\n" in name:
            raise TimeseriesError(f"invalid identifier {name!r}")
        return f'"{name}"'

    @staticmethod
    def _quote_str(value: str) -> str:
        """Single-quoted InfluxQL string literal."""
        escaped = str(value).replace("\\", "\\\\").replace("'", "\\'")
        return f"'{escaped}'"

    def create_bucket(self, bucket: str) -> None:
        def op():
            q = urllib.parse.quote(f"CREATE DATABASE {self._ident(bucket)}")
            self._post(f"/query?q={q}", b"")
        self._observed("CREATE_BUCKET", bucket, op)

    def delete_bucket(self, bucket: str) -> None:
        def op():
            q = urllib.parse.quote(f"DROP DATABASE {self._ident(bucket)}")
            self._post(f"/query?q={q}", b"")
        self._observed("DELETE_BUCKET", bucket, op)

    def list_buckets(self) -> list[str]:
        out = self._get("/query?q=" + urllib.parse.quote("SHOW DATABASES"))
        series = out.get("results", [{}])[0].get("series", [{}])[0]
        return sorted(v[0] for v in series.get("values", []))

    def write_point(self, bucket: str, measurement: str, ts: float,
                    fields: dict[str, float],
                    tags: dict | None = None) -> None:
        def op():
            line = encode_line(measurement, fields, tags, ts)
            self._post(f"/write?db={urllib.parse.quote(bucket)}",
                       line.encode())
        self._observed("WRITE", f"{bucket}/{measurement}", op)

    def query(self, bucket: str, measurement: str, field: str,
              start: float | None = None, end: float | None = None,
              tags: dict | None = None) -> list[tuple[float, float]]:
        def op():
            conds = []
            if start is not None:
                conds.append(f"time >= {int(start * 1e9)}")
            if end is not None:
                conds.append(f"time <= {int(end * 1e9)}")
            for k, v in (tags or {}).items():
                conds.append(f"{self._ident(k)} = {self._quote_str(v)}")
            q = (f"SELECT {self._ident(field)} "
                 f"FROM {self._ident(measurement)}")
            if conds:
                q += " WHERE " + " AND ".join(conds)
            out = self._get(
                f"/query?db={urllib.parse.quote(bucket)}&epoch=ns&q="
                + urllib.parse.quote(q))
            result = out.get("results", [{}])[0]
            if "error" in result:
                raise TimeseriesError(result["error"])
            series = result.get("series") or [{}]
            return [(v[0] / 1e9, v[1])
                    for v in series[0].get("values", [])]
        return self._observed("QUERY", f"{bucket}/{measurement}", op)

    def aggregate(self, bucket: str, measurement: str, field: str,
                  aggregator: str = "avg", start: float | None = None,
                  end: float | None = None) -> float | None:
        fn = {"avg": "MEAN", "sum": "SUM", "min": "MIN", "max": "MAX",
              "count": "COUNT"}.get(aggregator)
        if fn is None:
            raise TimeseriesError(f"unknown aggregator {aggregator!r}")
        conds = []
        if start is not None:
            conds.append(f"time >= {int(start * 1e9)}")
        if end is not None:
            conds.append(f"time <= {int(end * 1e9)}")
        q = (f"SELECT {fn}({self._ident(field)}) "
             f"FROM {self._ident(measurement)}")
        if conds:
            q += " WHERE " + " AND ".join(conds)
        out = self._get(f"/query?db={urllib.parse.quote(bucket)}&q="
                        + urllib.parse.quote(q))
        series = out.get("results", [{}])[0].get("series")
        if not series or not series[0].get("values"):
            return None
        return series[0]["values"][0][1]

    def health_check(self) -> dict[str, Any]:
        try:
            self._get("/ping?verbose=true")
            return {"status": "UP", "details": {"url": self.url}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------ mini server

class MiniInfluxServer(ThreadedHTTPMiniServer):
    """The 1.x HTTP surface over the embedded SeriesEngine, on the
    framework's own HTTP server (lifecycle from
    :class:`~gofr_tpu_torch.datasource.miniserver.ThreadedHTTPMiniServer`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.engines: dict[str, SeriesEngine] = {}
        self._lock = threading.Lock()

    def _engine(self, db: str) -> SeriesEngine:
        with self._lock:
            if db not in self.engines:
                self.engines[db] = SeriesEngine()
            return self.engines[db]

    def handle(self, request) -> tuple[int, bytes, str]:
        try:
            status, payload = self._route(request)
        except TimeseriesError as exc:
            status, payload = 400, {"error": str(exc)}
        body = b"" if payload is None else json.dumps(payload).encode()
        return status, body, "application/json"

    def _route(self, request) -> tuple[int, Any]:
        if request.path == "/ping":
            return 200, {"version": "1.8-mini"}
        if request.path == "/write":
            db = request.param("db") or "default"
            engine = self._engine(db)
            for line in request.body.decode().splitlines():
                if not line.strip():
                    continue
                measurement, tags, fields, ts = decode_line(line)
                stamp = ts if ts is not None else time.time()
                for field, value in fields.items():
                    engine.put(f"{db}/{measurement}", stamp, value,
                               dict(tags, _field=field))
            return 204, None
        if request.path == "/query":
            return self._query(request)
        return 404, {"error": f"no route {request.path}"}

    def _query(self, request) -> tuple[int, Any]:
        q = request.param("q").strip()
        db = request.param("db") or "default"
        upper = q.upper()
        if upper.startswith("CREATE DATABASE"):
            self._engine(q.split('"')[1] if '"' in q else q.split()[-1])
            return 200, {"results": [{}]}
        if upper.startswith("DROP DATABASE"):
            name = q.split('"')[1] if '"' in q else q.split()[-1]
            with self._lock:
                self.engines.pop(name, None)
            return 200, {"results": [{}]}
        if upper.startswith("SHOW DATABASES"):
            with self._lock:
                names = sorted(self.engines)
            return 200, {"results": [{"series": [
                {"name": "databases", "columns": ["name"],
                 "values": [[n] for n in names]}]}]}
        if upper.startswith("SELECT"):
            return self._select(db, q)
        return 400, {"results": [{"error": f"unsupported query {q!r}"}]}

    _AGG = {"MEAN": "avg", "SUM": "sum", "MIN": "min", "MAX": "max",
            "COUNT": "count"}

    def _select(self, db: str, q: str) -> tuple[int, Any]:
        import re
        m = re.match(
            r'SELECT\s+(?:(\w+)\()?"([^"]+)"\)?\s+FROM\s+"([^"]+)"'
            r'(?:\s+WHERE\s+(.*))?$', q, re.IGNORECASE)
        if not m:
            return 400, {"results": [{"error": f"cannot parse {q!r}"}]}
        agg, field, measurement, where = m.groups()
        start = end = None
        tags = {"_field": field}
        for cond in (where or "").split(" AND "):
            cond = cond.strip()
            if not cond:
                continue
            tm = re.match(r"time\s*(>=|<=)\s*(\d+)", cond)
            if tm:
                ns = int(tm.group(2)) / 1e9
                if tm.group(1) == ">=":
                    start = ns
                else:
                    end = ns
                continue
            km = re.match(r'"([^"]+)"\s*=\s*\'((?:[^\'\\]|\\.)*)\'', cond)
            if km:
                tags[km.group(1)] = (km.group(2)
                                     .replace("\\'", "'")
                                     .replace("\\\\", "\\"))
        engine = self._engine(db)
        key = f"{db}/{measurement}"
        if agg:
            name = self._AGG.get(agg.upper())
            if name is None:
                return 400, {"results": [{"error": f"agg {agg}?"}]}
            value = engine.aggregate(key, name, start=start, end=end,
                                     tags=tags)
            if value is None:
                return 200, {"results": [{}]}
            return 200, {"results": [{"series": [
                {"name": measurement, "columns": ["time", name],
                 "values": [[0, value]]}]}]}
        points = engine.query(key, start, end, tags)
        return 200, {"results": [{"series": [
            {"name": measurement, "columns": ["time", field],
             "values": [[int(ts * 1e9), v] for ts, v, _ in points]}]}]}
