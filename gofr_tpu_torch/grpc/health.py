"""Standard gRPC health service (``grpc.health.v1.Health``; a copy of
``gofr_tpu/grpc/health.py``), wire-compatible with protoc-generated
clients: the messages are tiny, so the protobuf wire format is encoded
by hand instead of depending on ``grpc_health`` or protobuf.

Wire shapes:
  HealthCheckRequest  { string service = 1; }
  HealthCheckResponse { enum ServingStatus status = 1; }
"""

from __future__ import annotations

SERVING = 1
NOT_SERVING = 2
SERVICE_UNKNOWN = 3

_STATUS_NAMES = {0: "UNKNOWN", 1: "SERVING", 2: "NOT_SERVING",
                 3: "SERVICE_UNKNOWN"}


def _encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while pos < len(data):
        byte = data[pos]
        result |= (byte & 0x7F) << shift
        pos += 1
        if not byte & 0x80:
            return result, pos
        shift += 7
    raise ValueError("truncated varint")


def encode_check_request(service: str = "") -> bytes:
    if not service:
        return b""
    raw = service.encode()
    return b"\x0a" + _encode_varint(len(raw)) + raw


def decode_check_request(data: bytes) -> str:
    pos = 0
    while pos < len(data):
        tag, pos = _decode_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            length, pos = _decode_varint(data, pos)
            return data[pos:pos + length].decode("utf-8", "replace")
        # skip unknown field
        if wire == 0:
            _, pos = _decode_varint(data, pos)
        elif wire == 2:
            length, pos = _decode_varint(data, pos)
            pos += length
        else:
            break
    return ""


def encode_check_response(status: int) -> bytes:
    return b"\x08" + _encode_varint(status)


def decode_check_response(data: bytes) -> int:
    pos = 0
    while pos < len(data):
        tag, pos = _decode_varint(data, pos)
        if tag >> 3 == 1 and tag & 7 == 0:
            value, pos = _decode_varint(data, pos)
            return value
    return 0


def status_name(status: int) -> str:
    return _STATUS_NAMES.get(status, "UNKNOWN")


class HealthState:
    """Mutable serving-status registry; '' is the overall server."""

    def __init__(self) -> None:
        self._statuses: dict[str, int] = {"": SERVING}

    def set(self, service: str, status: int) -> None:
        self._statuses[service] = status

    def check(self, service: str) -> int:
        return self._statuses.get(service, SERVICE_UNKNOWN)
