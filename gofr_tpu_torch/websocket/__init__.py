"""Websocket support: RFC 6455 codec, connections, manager, outbound
services, and the server-side upgrade runtime (the port's copy of
``gofr_tpu/websocket/``; the runtime runs plain handlers on the app's
pool, see :mod:`.runtime`)."""

from .connection import WSConnection, WSMessage
from .frames import WSProtocolError
from .manager import WSManager
from .service import WSHandshakeError, WSService, connect

__all__ = ["WSConnection", "WSMessage", "WSManager", "WSService",
           "WSProtocolError", "WSHandshakeError", "connect"]
