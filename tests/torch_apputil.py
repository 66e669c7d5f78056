"""Boot a real port App on ephemeral ports in a background thread for
tests: ``tests/apputil.py`` over ``gofr_tpu_torch``.

The analog of the reference's ``testutil.NewServerConfigs`` pattern
(pkg/gofr/testutil/port.go:51-71): tests exercise the actual server
over localhost.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import threading
import time

from gofr_tpu_torch.config import DictConfig


def grpc_channel(port: int):
    """aio channel with a LOCAL subchannel pool. grpc's default global
    pool shares live TCP subchannels across channels keyed by target,
    so when the kernel recycles an ephemeral port across two test
    servers in one process, a fresh channel can ride the dead server's
    cached connection — observed as spurious UNAVAILABLE/INTERNAL on
    the first RPC under a loaded suite."""
    import grpc
    return grpc.aio.insecure_channel(
        f"127.0.0.1:{port}",
        options=(("grpc.use_local_subchannel_pool", 1),))


class AppRunner:
    def __init__(self, app=None, config: dict | None = None, build=None):
        from gofr_tpu_torch.app import App
        cfg = {"HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "test-app"}
        cfg.update(config or {})
        self.app = app if app is not None else App(config=DictConfig(cfg))
        self._build = build  # callback(app) to register routes
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._error: BaseException | None = None

    def __enter__(self) -> "AppRunner":
        if self._build is not None:
            self._build(self.app)

        def runner() -> None:
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def main():
                # a failed start is recorded before __enter__ is woken,
                # so it can never read "no error" and return
                try:
                    await self.app.start()
                except Exception as exc:
                    self._error = exc
                    raise
                finally:
                    self._started.set()
                await self.app._stop_event.wait()

            try:
                self._loop.run_until_complete(main())
            except Exception as exc:
                if self._error is None:
                    self._error = exc
                self._started.set()
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise TimeoutError("app did not start")
        if self._error is not None:
            raise self._error
        time.sleep(0.01)
        return self

    def __exit__(self, *exc) -> None:
        if self._loop is not None and self._loop.is_running():
            asyncio.run_coroutine_threadsafe(self.app.stop(), self._loop).result(10)
        if self._thread is not None:
            self._thread.join(10)

    @property
    def port(self) -> int:
        return self.app.http_server.bound_port

    @property
    def metrics_port(self) -> int:
        return self.app.metrics_server.bound_port

    # -- tiny sync client
    def request(self, method: str, path: str, body: bytes | str | dict | None = None,
                headers: dict | None = None, port: int | None = None,
                timeout: float = 60):
        # 60 s default: generation endpoints compile on first hit and
        # the suite shares cores with benches/background work — a 10 s
        # cap flaked under load (r5, test_model_serving_from_disk_
        # checkpoint) while meaning nothing about correctness
        conn = http.client.HTTPConnection("127.0.0.1", port or self.port,
                                          timeout=timeout)
        headers = dict(headers or {})
        if isinstance(body, dict):
            body = json.dumps(body)
            headers.setdefault("Content-Type", "application/json")
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def get_json(self, path: str, **kw):
        status, headers, data = self.request("GET", path, **kw)
        return status, json.loads(data) if data else None
