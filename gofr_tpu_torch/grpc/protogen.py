""".proto → service skeleton generator (a copy of
``gofr_tpu/grpc/protogen.py`` whose output imports
``gofr_tpu_torch.grpc``):

    python -m gofr_tpu_torch.grpc.protogen chat.proto -o chat_gofr.py

generates, from the ``.proto`` alone:

- a ``@dataclass`` per message (the JSON-codec request/response shape;
  protoc-generated clients still interop through the server's proto
  codec path when message classes are supplied),
- a ``<Service>Base(GRPCService)`` skeleton per service — one
  ``@rpc`` / ``@server_stream_rpc`` / ``@client_stream_rpc`` /
  ``@bidi_stream_rpc`` method per RPC, raising NotImplementedError
  until filled in,
- a ``<Service>Client`` over ``grpc.aio`` with the matching method
  kinds, and
- when ``protoc`` is on PATH, the compiled ``FileDescriptorSet`` bytes
  (``FILE_DESCRIPTOR_SET``) — ``ChatServer.register_grpc_service`` picks
  the constant up from the generated module automatically (or feed it to
  ``GRPCServer.register_descriptors`` directly), after which server
  reflection answers ``file_containing_symbol`` with real descriptors
  instead of NOT_FOUND, so ``grpcurl`` works schema-aware.

The parser handles the proto3 subset service definitions use: package,
messages (scalar/repeated/map/nested-reference fields), services with
unary and streaming RPCs, comments, and options (ignored). It is a
generator's front-end, not a validator — protoc remains the authority
when present.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

# ----------------------------------------------------------------- model


@dataclass
class ProtoField:
    name: str
    type: str
    repeated: bool = False
    number: int = 0


@dataclass
class ProtoMessage:
    name: str
    fields: list[ProtoField] = field(default_factory=list)


@dataclass
class ProtoRPC:
    name: str
    request: str
    response: str
    client_stream: bool = False
    server_stream: bool = False


@dataclass
class ProtoService:
    name: str
    rpcs: list[ProtoRPC] = field(default_factory=list)


@dataclass
class ProtoFile:
    package: str = ""
    messages: list[ProtoMessage] = field(default_factory=list)
    services: list[ProtoService] = field(default_factory=list)


# ---------------------------------------------------------------- parser

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_PACKAGE = re.compile(r"\bpackage\s+([\w.]+)\s*;")
_MESSAGE = re.compile(r"\bmessage\s+(\w+)\s*\{")
_SERVICE = re.compile(r"\bservice\s+(\w+)\s*\{")
_RPC = re.compile(
    r"\brpc\s+(\w+)\s*\(\s*(stream\s+)?([\w.]+)\s*\)\s*"
    r"returns\s*\(\s*(stream\s+)?([\w.]+)\s*\)")
# applied per ';'-separated statement, not per line — proto bodies are
# whitespace-agnostic (`message Pet { string name = 1; int32 age = 2; }`)
_FIELD = re.compile(
    r"\s*(repeated\s+|optional\s+)?([\w.<>, ]+?)\s+(\w+)\s*=\s*(\d+)"
    r"\s*(?:\[[^\]]*\])?\s*$")


def _block(text: str, open_brace: int) -> tuple[str, int]:
    """Return the brace-balanced body starting after ``open_brace``."""
    depth = 1
    i = open_brace + 1
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return text[open_brace + 1:i - 1], i


def parse_proto(source: str) -> ProtoFile:
    text = _COMMENT.sub("", source)
    out = ProtoFile()
    m = _PACKAGE.search(text)
    if m:
        out.package = m.group(1)

    for m in _MESSAGE.finditer(text):
        body, _end = _block(text, m.end() - 1)
        msg = ProtoMessage(name=m.group(1))
        # nested messages are parsed as their own (flattened) entries;
        # strip their bodies so their fields don't leak into the parent
        flat = body
        for nm in _MESSAGE.finditer(body):
            nested_body, nested_end = _block(body, nm.end() - 1)
            flat = flat.replace(body[nm.start():nested_end], "")
        for stmt in flat.split(";"):
            f = _FIELD.match(stmt)
            if f is None:
                continue
            modifier, ftype, fname, num = f.groups()
            if ftype.split()[0] in ("option", "reserved", "oneof",
                                    "enum", "message", "rpc", "returns"):
                continue
            msg.fields.append(ProtoField(
                name=fname, type=ftype.strip(),
                repeated=(modifier or "").strip() == "repeated",
                number=int(num)))
        out.messages.append(msg)

    for m in _SERVICE.finditer(text):
        body, _end = _block(text, m.end() - 1)
        svc = ProtoService(name=m.group(1))
        for r in _RPC.finditer(body):
            name, req_stream, req, resp_stream, resp = r.groups()
            svc.rpcs.append(ProtoRPC(
                name=name, request=req.split(".")[-1],
                response=resp.split(".")[-1],
                client_stream=bool(req_stream),
                server_stream=bool(resp_stream)))
        out.services.append(svc)
    return out


# ------------------------------------------------------------- generator

_PY_TYPES = {
    "double": "float", "float": "float", "int32": "int", "int64": "int",
    "uint32": "int", "uint64": "int", "sint32": "int", "sint64": "int",
    "fixed32": "int", "fixed64": "int", "sfixed32": "int",
    "sfixed64": "int", "bool": "bool", "string": "str", "bytes": "bytes",
}


def _py_type(f: ProtoField, known: set[str]) -> tuple[str, str]:
    """-> (annotation, default expr)."""
    if f.type.startswith("map<"):
        return "dict", "field(default_factory=dict)"
    base = _PY_TYPES.get(f.type)
    if base is None:
        base = f'"{f.type}"' if f.type in known else "dict"
    if f.repeated:
        return "list", "field(default_factory=list)"
    defaults = {"float": "0.0", "int": "0", "bool": "False",
                "str": '""', "bytes": 'b""', "dict": "None"}
    return base, defaults.get(base, "None")


def _descriptor_set(proto_path: Path) -> bytes | None:
    """Compile with protoc when available — real descriptors make the
    reflection surface schema-aware."""
    protoc = shutil.which("protoc")
    if protoc is None:
        return None
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "fds.bin"
        try:
            proc = subprocess.run(
                [protoc, f"-I{proto_path.parent}", str(proto_path),
                 "--include_imports", f"--descriptor_set_out={out}"],
                capture_output=True, text=True, timeout=60)
        except subprocess.TimeoutExpired:
            return None  # degrade like every other protoc failure
        if proc.returncode != 0:
            return None
        return out.read_bytes()


_KIND_DECOR = {
    (False, False): "rpc",
    (False, True): "server_stream_rpc",
    (True, False): "client_stream_rpc",
    (True, True): "bidi_stream_rpc",
}


def generate(proto_path: str | Path) -> str:
    proto_path = Path(proto_path)
    pf = parse_proto(proto_path.read_text())
    known = {m.name for m in pf.messages}
    lines: list[str] = [
        f'"""Generated from {proto_path.name} by gofr_tpu_torch.grpc.protogen',
        "— the gofr-cli `wrap grpc` analog. Fill in the *Base methods.",
        '"""',
        "",
        "from __future__ import annotations",
        "",
        "from dataclasses import dataclass, field",
        "from typing import Any, AsyncIterator",
        "",
        "from gofr_tpu_torch.grpc.service import (GRPCService, bidi_stream_rpc,",
        "                                   client_stream_rpc, rpc,",
        "                                   server_stream_rpc)",
        "",
    ]

    for msg in pf.messages:
        lines.append("@dataclass")
        lines.append(f"class {msg.name}:")
        if not msg.fields:
            lines.append("    pass")
        for f in msg.fields:
            ann, default = _py_type(f, known)
            lines.append(f"    {f.name}: {ann} = {default}")
        lines += [
            "",
            "    @classmethod",
            "    def from_dict(cls, d):",
            "        d = d if isinstance(d, dict) else {}",
            "        names = set(cls.__dataclass_fields__)",
            "        return cls(**{k: v for k, v in d.items()"
            " if k in names})",
            "", ""]

    for svc in pf.services:
        full = f"{pf.package}.{svc.name}" if pf.package else svc.name
        lines.append(f"class {svc.name}Base(GRPCService):")
        lines.append(f'    """Server skeleton for `{full}` — subclass'
                     " and implement each RPC.\"\"\"")
        lines.append("")
        lines.append(f'    name = "{full}"')
        for r in svc.rpcs:
            decor = _KIND_DECOR[(r.client_stream, r.server_stream)]
            lines.append("")
            lines.append(f"    @{decor}")
            if r.server_stream:
                lines.append(f"    async def {r.name}(self, ctx, request)"
                             " -> AsyncIterator[dict]:")
            else:
                lines.append(f"    async def {r.name}(self, ctx, request)"
                             " -> Any:")
            lines.append(f'        """rpc {r.name}('
                         f'{"stream " if r.client_stream else ""}'
                         f'{r.request}) returns ('
                         f'{"stream " if r.server_stream else ""}'
                         f'{r.response})"""')
            lines.append(f"        req = {r.request}.from_dict(request)"
                         if r.request in known else
                         "        req = request")
            lines.append("        raise NotImplementedError"
                         f'("implement {r.name}")')
            if r.server_stream:
                lines.append("        yield {}  # pragma: no cover")
        lines += ["", ""]

        lines.append(f"class {svc.name}Client:")
        lines.append(f'    """grpc.aio client for `{full}` '
                     '(JSON codec)."""')
        lines += [
            "",
            "    def __init__(self, channel):",
            "        import json as _json",
            "        self._channel = channel",
            "        self._dumps = lambda o: _json.dumps(",
            "            o.__dict__ if hasattr(o, '__dataclass_fields__')"
            " else o).encode()",
            "        self._loads = lambda b: _json.loads(b or b'{}')",
        ]
        for r in svc.rpcs:
            path = f"/{full}/{r.name}"
            if not r.client_stream and not r.server_stream:
                lines += [
                    "",
                    f"    async def {r.name}(self, request):",
                    f"        call = self._channel.unary_unary(",
                    f'            "{path}",',
                    "            request_serializer=self._dumps,",
                    "            response_deserializer=self._loads)",
                    "        return await call(request)",
                ]
            elif r.server_stream and not r.client_stream:
                lines += [
                    "",
                    f"    def {r.name}(self, request):",
                    f"        call = self._channel.unary_stream(",
                    f'            "{path}",',
                    "            request_serializer=self._dumps,",
                    "            response_deserializer=self._loads)",
                    "        return call(request)",
                ]
            elif r.client_stream and not r.server_stream:
                lines += [
                    "",
                    f"    async def {r.name}(self, request_iterator):",
                    f"        call = self._channel.stream_unary(",
                    f'            "{path}",',
                    "            request_serializer=self._dumps,",
                    "            response_deserializer=self._loads)",
                    "        return await call(request_iterator)",
                ]
            else:
                lines += [
                    "",
                    f"    def {r.name}(self, request_iterator):",
                    f"        call = self._channel.stream_stream(",
                    f'            "{path}",',
                    "            request_serializer=self._dumps,",
                    "            response_deserializer=self._loads)",
                    "        return call(request_iterator)",
                ]
        lines += ["", ""]

    fds = _descriptor_set(proto_path)
    if fds is not None:
        lines.append("#: protoc-compiled FileDescriptorSet — register"
                     " with the server so")
        lines.append("#: reflection answers file_containing_symbol"
                     " with real descriptors")
        lines.append(f"FILE_DESCRIPTOR_SET = {fds!r}")
    else:
        lines.append("FILE_DESCRIPTOR_SET = None  # protoc not on PATH"
                     " at generation time")
    lines.append("")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m gofr_tpu_torch.grpc.protogen",
        description="Generate a gofr_tpu_torch gRPC service skeleton "
                    "from a .proto file")
    ap.add_argument("proto", help="path to the .proto file")
    ap.add_argument("-o", "--out", help="output .py path "
                    "(default: <proto>_gofr.py)")
    args = ap.parse_args(argv)
    src = Path(args.proto)
    out = Path(args.out) if args.out else \
        src.with_name(src.stem + "_gofr.py")
    out.write_text(generate(src))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
