"""gRPC server reflection (``grpc.reflection.v1alpha`` and ``v1``; a
copy of ``gofr_tpu/grpc/reflection.py``), wire-compatible with grpcurl
and evans: hand-encoded protobuf like :mod:`.health`, no
``grpc_reflection`` dependency. The server registers it only when
``GRPC_ENABLE_REFLECTION`` is ``"true"``.

Supported requests: ``list_services`` returns every registered service
(the application's, health and reflection itself);
``file_by_filename`` and ``file_containing_symbol`` answer from the
:class:`DescriptorRegistry` (fed a protoc-compiled ``FileDescriptorSet``,
as :mod:`.protogen` embeds it), else ``NOT_FOUND``: JSON-codec services
carry no compiled descriptors, and grpcurl falls back cleanly.

Wire shapes used (v1alpha and v1 are field-identical):
  ServerReflectionRequest  { string host = 1; oneof message_request {
      string file_by_filename = 3; string file_containing_symbol = 4;
      ... string list_services = 7; } }
  ServerReflectionResponse { string valid_host = 1;
      ServerReflectionRequest original_request = 2;
      oneof message_response {
        ListServiceResponse list_services_response = 6;
        ErrorResponse error_response = 7; } }
  ListServiceResponse { repeated ServiceResponse service = 1; }
  ServiceResponse { string name = 1; }
  ErrorResponse { int32 error_code = 1; string error_message = 2; }
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import grpc

from .health import _decode_varint, _encode_varint

NOT_FOUND = 5           # grpc.StatusCode.NOT_FOUND.value[0]
UNIMPLEMENTED = 12

#: request fields that carry the oneof discriminator
_REQUEST_FIELDS = {3: "file_by_filename", 4: "file_containing_symbol",
                   5: "file_containing_extension",
                   6: "all_extension_numbers_of_type", 7: "list_services"}


def decode_reflection_request(data: bytes) -> tuple[str, bytes, str]:
    """-> (oneof field name, raw request bytes, argument string)."""
    pos = 0
    which, arg = "", ""
    while pos < len(data):
        tag, pos = _decode_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            length, pos = _decode_varint(data, pos)
            value = data[pos:pos + length]
            pos += length
            if field in _REQUEST_FIELDS:
                which = _REQUEST_FIELDS[field]
                arg = value.decode("utf-8", "replace")
        elif wire == 0:
            _, pos = _decode_varint(data, pos)
        else:
            break
    return which, data, arg


def _field(num: int, payload: bytes) -> bytes:
    return _encode_varint((num << 3) | 2) + _encode_varint(len(payload)) \
        + payload


def encode_list_services_response(request: bytes,
                                  names: Iterable[str]) -> bytes:
    services = b"".join(
        _field(1, _field(1, name.encode())) for name in names)
    return _field(2, request) + _field(6, services)


def encode_error_response(request: bytes, code: int, message: str) -> bytes:
    err = (_encode_varint(1 << 3) + _encode_varint(code)
           + _field(2, message.encode()))
    return _field(2, request) + _field(7, err)


class DescriptorRegistry:
    """Serialized ``FileDescriptorProto`` store keyed by file name and
    symbol, fed from protoc-compiled ``FileDescriptorSet`` bytes (the
    ``FILE_DESCRIPTOR_SET`` constant :mod:`.protogen` emits). With one
    registered, reflection answers descriptor requests for real —
    grpcurl becomes schema-aware instead of falling back."""

    def __init__(self) -> None:
        self._files: dict[str, bytes] = {}        # file name -> fdp bytes
        self._deps: dict[str, list[str]] = {}
        self._symbols: dict[str, str] = {}         # symbol -> file name

    @staticmethod
    def _fields(blob: bytes):
        pos = 0
        while pos < len(blob):
            tag, pos = _decode_varint(blob, pos)
            num, wire = tag >> 3, tag & 7
            if wire == 2:
                length, pos = _decode_varint(blob, pos)
                yield num, blob[pos:pos + length]
                pos += length
            elif wire == 0:
                value, pos = _decode_varint(blob, pos)
                yield num, value
            else:  # 64/32-bit fields don't appear in descriptors we read
                return

    def add_serialized_set(self, fds: bytes) -> None:
        for num, value in self._fields(fds):
            if num == 1 and isinstance(value, bytes):
                self._add_file(value)

    def _message_symbols(self, desc: bytes) -> list[str]:
        """DescriptorProto -> its name plus dotted nested message/enum
        names (field 3 nested_type, field 4 enum_type), recursively —
        `grpcurl describe pkg.Outer.Inner` must resolve."""
        own = ""
        nested: list[str] = []
        for num, value in self._fields(desc):
            if not isinstance(value, bytes):
                continue
            if num == 1:
                own = value.decode()
            elif num == 3:
                nested.extend(self._message_symbols(value))
            elif num == 4:  # EnumDescriptorProto: name is field 1 too
                for n2, v2 in self._fields(value):
                    if n2 == 1 and isinstance(v2, bytes):
                        nested.append(v2.decode())
        if not own:
            return []
        return [own] + [f"{own}.{n}" for n in nested]

    def _add_file(self, fdp: bytes) -> None:
        name, package = "", ""
        deps: list[str] = []
        symbols: list[str] = []
        for num, value in self._fields(fdp):
            if not isinstance(value, bytes):
                continue
            if num == 1:
                name = value.decode()
            elif num == 2:
                package = value.decode()
            elif num == 3:
                deps.append(value.decode())
            elif num in (4, 5):      # message_type / top-level enum
                symbols.extend(self._message_symbols(value))
            elif num == 6:           # service + its methods
                inner_name = ""
                methods: list[str] = []
                for n2, v2 in self._fields(value):
                    if n2 == 1 and isinstance(v2, bytes):
                        inner_name = v2.decode()
                    elif n2 == 2 and isinstance(v2, bytes):
                        for n3, v3 in self._fields(v2):
                            if n3 == 1 and isinstance(v3, bytes):
                                methods.append(v3.decode())
                if inner_name:
                    symbols.append(inner_name)
                    symbols.extend(f"{inner_name}.{m}" for m in methods)
        self._files[name] = fdp
        self._deps[name] = deps
        prefix = f"{package}." if package else ""
        for sym in symbols:
            self._symbols[prefix + sym] = name

    def _with_deps(self, name: str) -> list[bytes]:
        out: list[bytes] = []
        seen: set[str] = set()
        stack = [name]
        while stack:
            n = stack.pop()
            if n in seen or n not in self._files:
                continue
            seen.add(n)
            out.append(self._files[n])
            stack.extend(self._deps.get(n, []))
        return out

    def file_by_filename(self, filename: str) -> list[bytes] | None:
        return self._with_deps(filename) if filename in self._files \
            else None

    def file_containing_symbol(self, symbol: str) -> list[bytes] | None:
        name = self._symbols.get(symbol)
        return self._with_deps(name) if name is not None else None


def encode_file_descriptor_response(request: bytes,
                                    fdps: list[bytes]) -> bytes:
    # FileDescriptorResponse { repeated bytes file_descriptor_proto = 1 }
    # in ServerReflectionResponse oneof field 4
    payload = b"".join(_field(1, f) for f in fdps)
    return _field(2, request) + _field(4, payload)


def reflection_handler(service_names: Callable[[], list[str]],
                       registry: DescriptorRegistry | None = None):
    """Generic handlers for both reflection service versions."""

    def info(request_iter, grpc_ctx) -> Iterator[bytes]:
        for raw in request_iter:
            which, original, arg = decode_reflection_request(raw)
            if which == "list_services":
                yield encode_list_services_response(original,
                                                    service_names())
            elif which in ("file_by_filename", "file_containing_symbol",
                           "file_containing_extension"):
                fdps = None
                if registry is not None:
                    if which == "file_by_filename":
                        fdps = registry.file_by_filename(arg)
                    elif which == "file_containing_symbol":
                        fdps = registry.file_containing_symbol(arg)
                if fdps:
                    yield encode_file_descriptor_response(original, fdps)
                else:
                    yield encode_error_response(
                        original, NOT_FOUND,
                        "no descriptor registered for that symbol"
                        if registry is not None else
                        "JSON-codec services carry no proto descriptors")
            else:
                yield encode_error_response(original, UNIMPLEMENTED,
                                            f"unsupported: {which or '?'}")

    handler = grpc.stream_stream_rpc_method_handler(
        info, request_deserializer=lambda b: b,
        response_serializer=lambda b: b)
    return [grpc.method_handlers_generic_handler(
        name, {"ServerReflectionInfo": handler})
        for name in ("grpc.reflection.v1alpha.ServerReflection",
                     "grpc.reflection.v1.ServerReflection")]
