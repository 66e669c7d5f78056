"""Google Cloud Pub/Sub backend speaking the REST protocol, plus an
in-process emulator.

The reference ships a Google Pub/Sub module behind the common pub/sub
interface (reference pkg/gofr/datasource/pubsub/google/google.go)
using Google's client library; this backend speaks the service's REST
surface directly (the same JSON API the official emulator serves, so
``PUBSUB_EMULATOR_HOST``-style deployments work unchanged):

- ``PUT  /v1/projects/{p}/topics/{t}`` — create topic
- ``POST /v1/projects/{p}/topics/{t}:publish`` — base64 data + attrs
- ``PUT  /v1/projects/{p}/subscriptions/{s}`` — create subscription
- ``POST /v1/projects/{p}/subscriptions/{s}:pull`` — long-poll pull
- ``POST /v1/projects/{p}/subscriptions/{s}:acknowledge``

The framework's consumer groups map to subscriptions named
``{group}-{topic}`` — every group gets each message once (fan-out
across groups, competing consumers within one), exactly the reference
semantics. ``Message.commit`` acknowledges; unacked messages redeliver
after the ack deadline (at-least-once).

:class:`MiniPubSubEmulator` implements the same REST surface on the
framework's own HTTP server with deadline-based redelivery — the
hermetic test stand-in for gcloud's emulator.

Against real GCP, inject an OAuth bearer token via ``auth_headers``
(zero-egress CI never exercises that path).

The port's copy of ``gofr_tpu/pubsub/google.py``. The client calls the port's synchronous
``service.HTTPService`` on a worker thread; the emulator runs on the
port's ``http.server.HTTPServer``.
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
import time
from typing import Any

from .message import Message


class GooglePubSubError(Exception):
    pass


class GooglePubSubClient:
    """REST Pub/Sub client on the resilient in-house HTTP service
    client (retry/CB/timeout ride along for free)."""

    def __init__(self, endpoint: str = "http://127.0.0.1:8085",
                 project: str = "gofr", *,
                 ack_deadline_s: int = 10,
                 auth_headers: dict | None = None,
                 timeout: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.project = project
        self.ack_deadline_s = ack_deadline_s
        self.auth_headers = dict(auth_headers or {})
        self.timeout = timeout
        self.logger: Any = None
        self.metrics: Any = None
        self.tracer: Any = None
        self._http: Any = None
        self._known: set[str] = set()       # created topics/subs

    def use_logger(self, logger: Any) -> None:
        self.logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self.metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self.tracer = tracer

    def _service(self):
        if self._http is None:
            from ..service import HTTPService
            self._http = HTTPService(self.endpoint, timeout=self.timeout,
                                     logger=self.logger,
                                     metrics=self.metrics,
                                     service_name="google-pubsub")
        return self._http

    async def _call(self, method: str, path: str, payload: dict | None,
                    ok_conflict: bool = False) -> dict:
        # the port's service client is synchronous: each call runs on a
        # worker thread, off the loop
        resp = await asyncio.to_thread(
            self._service().request, method, path, json=payload,
            headers=self.auth_headers)
        if resp.status == 409 and ok_conflict:
            return {}
        if resp.status >= 400:
            raise GooglePubSubError(
                f"{method} {path} -> {resp.status}: {resp.body[:200]!r}")
        return json.loads(resp.body or b"{}")

    # ------------------------------------------------------------ admin
    def _topic_path(self, topic: str) -> str:
        return f"/v1/projects/{self.project}/topics/{topic}"

    def _sub_path(self, sub: str) -> str:
        return f"/v1/projects/{self.project}/subscriptions/{sub}"

    async def _ensure_topic(self, topic: str) -> None:
        if topic in self._known:
            return
        await self._call("PUT", self._topic_path(topic), {},
                         ok_conflict=True)
        self._known.add(topic)

    async def _ensure_subscription(self, topic: str, sub: str) -> None:
        if sub in self._known:
            return
        await self._ensure_topic(topic)
        await self._call(
            "PUT", self._sub_path(sub),
            {"topic": f"projects/{self.project}/topics/{topic}",
             "ackDeadlineSeconds": self.ack_deadline_s},
            ok_conflict=True)
        self._known.add(sub)

    def create_topic(self, name: str) -> None:
        task = asyncio.ensure_future(self._ensure_topic(name))
        task.add_done_callback(self._log_ack_errors)

    def delete_topic(self, name: str) -> None:
        async def _delete() -> None:
            await self._call("DELETE", self._topic_path(name), None,
                             ok_conflict=True)
            self._known.discard(name)
        task = asyncio.ensure_future(_delete())
        task.add_done_callback(self._log_ack_errors)

    # ---------------------------------------------------------- publish
    async def publish(self, topic: str, value: bytes | str | dict,
                      key: str = "", metadata: dict | None = None) -> None:
        if isinstance(value, dict):
            value = json.dumps(value).encode()
        elif isinstance(value, str):
            value = value.encode()
        await self._ensure_topic(topic)
        attributes = {str(k): str(v) for k, v in (metadata or {}).items()}
        if key:
            attributes["ordering_key"] = key
        start = time.perf_counter()
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count",
                                           topic=topic)
        await self._call(
            "POST", self._topic_path(topic) + ":publish",
            {"messages": [{"data": base64.b64encode(value).decode(),
                           "attributes": attributes}]})
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_success_count",
                                           topic=topic)
            self.metrics.record_histogram("app_pubsub_publish_latency",
                                          time.perf_counter() - start)

    # -------------------------------------------------------- subscribe
    async def subscribe(self, topic: str, group: str = "default") -> Message:
        sub = f"{group}-{topic}"
        await self._ensure_subscription(topic, sub)
        while True:
            out = await self._call(
                "POST", self._sub_path(sub) + ":pull",
                {"maxMessages": 1, "returnImmediately": False})
            received = out.get("receivedMessages") or []
            if not received:
                await asyncio.sleep(0.05)
                continue
            entry = received[0]
            ack_id = entry["ackId"]
            msg = entry.get("message", {})
            data = base64.b64decode(msg.get("data", ""))
            attrs = msg.get("attributes") or {}
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_pubsub_subscribe_total_count", topic=topic)

            def committer(a=ack_id, s=sub) -> None:
                task = asyncio.ensure_future(self._ack(s, a))
                task.add_done_callback(self._log_ack_errors)
            return Message(topic=topic, value=data,
                           key=attrs.get("ordering_key", ""),
                           metadata=attrs, committer=committer)

    async def _ack(self, sub: str, ack_id: str) -> None:
        await self._call("POST", self._sub_path(sub) + ":acknowledge",
                         {"ackIds": [ack_id]})

    def _log_ack_errors(self, task: "asyncio.Task") -> None:
        exc = task.exception() if not task.cancelled() else None
        if exc is not None and self.logger is not None:
            self.logger.error(f"pubsub background call failed: {exc!r}")

    # ------------------------------------------------------------ misc
    def health_check(self) -> dict:
        # stateless REST client: connections are per-request, so health
        # is config presence; pull/publish failures surface via logs,
        # metrics, and the subscriber runtime's backoff
        return {"status": "UP",
                "backend": "google-pubsub",
                "details": {"endpoint": self.endpoint,
                            "project": self.project}}

    async def close(self) -> None:
        self._http = None


# ------------------------------------------------------------- emulator

class MiniPubSubEmulator:
    """The gcloud-emulator stand-in on the framework's own HTTP server:
    topics, subscriptions, base64 messages, ack-deadline redelivery."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.topics: dict[str, set[str]] = {}     # topic -> sub names
        #: sub -> {"topic", "deadline", "queue": [msg], "outstanding":
        #:         {ack_id: (msg, redeliver_at)}}
        self.subs: dict[str, dict] = {}
        self._ids = itertools.count(1)
        self._server: Any = None

    async def start(self) -> None:
        from ..http.server import HTTPServer
        from ..http.responder import ResponseData

        async def handler(request) -> ResponseData:
            try:
                status, payload = self._route(
                    request.method, request.path,
                    json.loads(request.body) if request.body else {})
            except GooglePubSubError as exc:
                status, payload = 400, {"error": {"message": str(exc)}}
            return ResponseData(status=status,
                                body=json.dumps(payload).encode(),
                                content_type="application/json")

        self._server = HTTPServer(handler, host=self.host, port=self.port)
        await self._server.start()
        self.port = self._server.bound_port

    # one dispatcher keeps the wire surface in a single place
    def _route(self, method: str, path: str, body: dict) -> tuple[int, dict]:
        parts = path.strip("/").split("/")
        # /v1/projects/{p}/topics/{t}[:verb] | subscriptions/{s}[:verb]
        if len(parts) != 5 or parts[0] != "v1" or parts[1] != "projects":
            return 404, {"error": {"message": f"bad path {path}"}}
        kind, last = parts[3], parts[4]
        name, _, verb = last.partition(":")

        if kind == "topics":
            if method == "PUT" and not verb:
                if name in self.topics:
                    return 409, {"error": {"message": "exists"}}
                self.topics[name] = set()
                return 200, {"name": f"projects/{parts[2]}/topics/{name}"}
            if method == "DELETE" and not verb:
                self.topics.pop(name, None)
                return 200, {}
            if verb == "publish":
                return self._publish(name, body)
        elif kind == "subscriptions":
            if method == "PUT" and not verb:
                return self._create_sub(name, body)
            if verb == "pull":
                return self._pull(name, body)
            if verb == "acknowledge":
                return self._ack(name, body)
        return 404, {"error": {"message": f"bad route {method} {path}"}}

    def _publish(self, topic: str, body: dict) -> tuple[int, dict]:
        self.topics.setdefault(topic, set())
        ids = []
        for msg in body.get("messages", []):
            mid = str(next(self._ids))
            ids.append(mid)
            entry = {"data": msg.get("data", ""),
                     "attributes": msg.get("attributes") or {},
                     "messageId": mid,
                     "publishTime": time.strftime(
                         "%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
            for sub_name in self.topics[topic]:
                self.subs[sub_name]["queue"].append(entry)
        return 200, {"messageIds": ids}

    def _create_sub(self, name: str, body: dict) -> tuple[int, dict]:
        if name in self.subs:
            return 409, {"error": {"message": "exists"}}
        topic = (body.get("topic") or "").rsplit("/", 1)[-1]
        if topic not in self.topics:
            return 404, {"error": {"message": f"no topic {topic}"}}
        self.subs[name] = {"topic": topic, "queue": [],
                           "deadline": int(body.get("ackDeadlineSeconds",
                                                    10)),
                           "outstanding": {}}
        self.topics[topic].add(name)
        return 200, {"name": name}

    def _redeliver_expired(self, sub: dict) -> None:
        now = time.monotonic()
        expired = [a for a, (_, t) in sub["outstanding"].items() if t <= now]
        for ack_id in expired:
            msg, _ = sub["outstanding"].pop(ack_id)
            sub["queue"].append(msg)

    def _pull(self, name: str, body: dict) -> tuple[int, dict]:
        sub = self.subs.get(name)
        if sub is None:
            return 404, {"error": {"message": f"no subscription {name}"}}
        self._redeliver_expired(sub)
        n = max(1, int(body.get("maxMessages", 1)))
        out = []
        while sub["queue"] and len(out) < n:
            msg = sub["queue"].pop(0)
            ack_id = f"ack-{next(self._ids)}"
            sub["outstanding"][ack_id] = (
                msg, time.monotonic() + sub["deadline"])
            out.append({"ackId": ack_id, "message": msg})
        return 200, {"receivedMessages": out}

    def _ack(self, name: str, body: dict) -> tuple[int, dict]:
        sub = self.subs.get(name)
        if sub is None:
            return 404, {"error": {"message": f"no subscription {name}"}}
        for ack_id in body.get("ackIds", []):
            sub["outstanding"].pop(ack_id, None)
        return 200, {}

    async def close(self) -> None:
        if self._server is not None:
            await self._server.shutdown()
