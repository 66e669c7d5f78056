"""SFTP v3 over the framework's own SSH2 transport, plus a mini
SSH+SFTP server (the port's copy of ``gofr_tpu/datasource/sftp_wire.py``).

The reference's SFTP module is a driver-backed network client
(datasource/file/sftp over pkg/sftp). This is the protocol itself:
SFTP version 3 (draft-ietf-secsh-filexfer-02) request/response packets
— OPEN/READ/WRITE/CLOSE, OPENDIR/READDIR, STAT, REMOVE/RENAME/MKDIR/
RMDIR — framed over an authenticated
:class:`~gofr_tpu_torch.datasource.ssh_transport.SSHClientTransport`
session channel. :class:`SFTPWire` exposes the framework's FileSystem
surface (create/read/append/remove/rename/stat/exists/mkdir/read_dir/
read_rows), and also the paramiko-style verbs
(putfo/getfo/listdir/...) that
:class:`~gofr_tpu_torch.datasource.ftp.SFTPFileSystem` accepts as an
injected client — so the previously injection-only SFTP slot now has
a native stack.

:class:`MiniSFTPServer` is a real SSH server (verified password auth,
ed25519 host key, the same from-spec transport) serving a jailed
directory tree — hermetic tests run the full stack: kex, encryption,
MAC, auth, channels, SFTP.
"""

from __future__ import annotations

import io
import os
import posixpath
import socket
import socketserver
import stat as stat_mod
import struct
import threading
from pathlib import Path
from typing import Any

from . import Instrumented
from .file_store import FileError, FileInfo, RowReader
from .ssh_transport import (Reader, SSHAuthError, SSHClientTransport,
                            SSHError, SSHServerTransport, sb, ss)

FXP_INIT = 1
FXP_VERSION = 2
FXP_OPEN = 3
FXP_CLOSE = 4
FXP_READ = 5
FXP_WRITE = 6
FXP_LSTAT = 7
FXP_OPENDIR = 11
FXP_READDIR = 12
FXP_REMOVE = 13
FXP_MKDIR = 14
FXP_RMDIR = 15
FXP_STAT = 17
FXP_RENAME = 18
FXP_STATUS = 101
FXP_HANDLE = 102
FXP_DATA = 103
FXP_NAME = 104
FXP_ATTRS = 105

FX_OK = 0
FX_EOF = 1
FX_NO_SUCH_FILE = 2
FX_PERMISSION_DENIED = 3
FX_FAILURE = 4

PFLAG_READ = 0x01
PFLAG_WRITE = 0x02
PFLAG_APPEND = 0x04
PFLAG_CREAT = 0x08
PFLAG_TRUNC = 0x10

ATTR_SIZE = 0x01
ATTR_PERMISSIONS = 0x04
ATTR_ACMODTIME = 0x08

_CHUNK = 24 * 1024


class SFTPError(FileError):
    def __init__(self, message: str, code: int = FX_FAILURE) -> None:
        super().__init__(message)
        self.code = code


def _attrs(size: int, is_dir: bool, mtime: float) -> bytes:
    perms = (stat_mod.S_IFDIR | 0o755) if is_dir else (stat_mod.S_IFREG
                                                       | 0o644)
    return struct.pack("!I", ATTR_SIZE | ATTR_PERMISSIONS | ATTR_ACMODTIME) \
        + struct.pack("!Q", size) + struct.pack("!I", perms) \
        + struct.pack("!II", int(mtime), int(mtime))


def _parse_attrs(r: Reader) -> tuple[int, bool, float]:
    """-> (size, is_dir, mtime)."""
    flags = r.uint32()
    size = r.uint64() if flags & ATTR_SIZE else 0
    if flags & 0x02:  # uid/gid
        r.uint32()
        r.uint32()
    perms = r.uint32() if flags & ATTR_PERMISSIONS else 0
    mtime = 0.0
    if flags & ATTR_ACMODTIME:
        r.uint32()
        mtime = float(r.uint32())
    # S_ISDIR, not a bit test: S_IFSOCK contains the S_IFDIR bit
    return size, stat_mod.S_ISDIR(perms), mtime


# ----------------------------------------------------------------- client

class SFTPWire(Instrumented):
    """FileSystem surface over SFTP v3 on the framework's SSH stack."""

    metric = "app_sftp_stats"
    log_tag = "SFTP"

    def __init__(self, host: str = "127.0.0.1", port: int = 22, *,
                 username: str = "", password: str = "",
                 expected_host_key: bytes | None = None,
                 insecure_skip_host_key: bool = False,
                 timeout_s: float = 30.0) -> None:
        self.host = host
        self.port = port
        self.username = username
        self.password = password
        self.expected_host_key = expected_host_key
        self.insecure_skip_host_key = insecure_skip_host_key
        self.timeout_s = timeout_s
        self._transport: SSHClientTransport | None = None
        self._channel = 0
        self._ids = 0
        self._buf = b""
        self._lock = threading.RLock()

    # ------------------------------------------------------------ session
    def connect(self) -> None:
        if self._transport is not None:
            self.close()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        transport = SSHClientTransport(sock)
        try:
            transport.handshake(
                username=self.username, password=self.password,
                expected_host_key=self.expected_host_key,
                insecure_skip_host_key=self.insecure_skip_host_key)
            self._channel = transport.open_session_channel()
            transport.request_subsystem(self._channel, "sftp")
            self._transport = transport
            self._buf = b""
            self._send_raw(bytes([FXP_INIT]) + struct.pack("!I", 3))
            kind, body = self._recv_sftp()
            if kind != FXP_VERSION:
                raise SFTPError("server did not answer INIT")
        except BaseException:
            sock.close()
            self._transport = None
            raise
        if self.logger is not None:
            self.logger.info("connected to sftp", host=self.host,
                             port=self.port, user=self.username)

    def close(self) -> None:
        if self._transport is not None:
            try:
                self._transport.sock.close()
            except OSError:
                pass
            self._transport = None

    def _send_raw(self, sftp_packet: bytes) -> None:
        assert self._transport is not None
        self._transport.send_channel_data(
            self._channel, struct.pack("!I", len(sftp_packet))
            + sftp_packet)

    def _recv_sftp(self) -> tuple[int, bytes]:
        assert self._transport is not None
        while True:
            if len(self._buf) >= 4:
                (length,) = struct.unpack("!I", self._buf[:4])
                if len(self._buf) >= 4 + length:
                    body = self._buf[4:4 + length]
                    self._buf = self._buf[4 + length:]
                    return body[0], body[1:]
            self._buf += self._transport.recv_channel_data()

    def _request(self, kind: int, payload: bytes) -> tuple[int, Reader]:
        with self._lock:
            if self._transport is None:
                raise SFTPError("not connected; call connect() first")
            self._ids += 1
            req_id = self._ids
            try:
                self._send_raw(bytes([kind]) + struct.pack("!I", req_id)
                               + payload)
                while True:
                    rkind, body = self._recv_sftp()
                    r = Reader(body)
                    if r.uint32() == req_id:
                        return rkind, r
            except (OSError, TimeoutError, SSHError) as exc:
                self.close()  # poisoned stream: responses would pair
                raise SFTPError(                 # with the next request
                    f"connection lost mid-request ({exc})") from exc

    @staticmethod
    def _status(r: Reader) -> tuple[int, str]:
        code = r.uint32()
        message = r.text() if r.off < len(r.data) else ""
        return code, message

    def _expect_ok(self, kind: int, r: Reader, what: str) -> None:
        if kind != FXP_STATUS:
            raise SFTPError(f"{what}: unexpected reply {kind}")
        code, message = self._status(r)
        if code != FX_OK:
            raise SFTPError(f"{what}: {message or code}", code=code)

    def _open(self, path: str, pflags: int) -> bytes:
        kind, r = self._request(
            FXP_OPEN, ss(path) + struct.pack("!I", pflags)
            + struct.pack("!I", 0))
        if kind == FXP_HANDLE:
            return r.string()
        code, message = self._status(r)
        raise SFTPError(f"open {path}: {message or code}", code=code)

    def _close_handle(self, handle: bytes) -> None:
        kind, r = self._request(FXP_CLOSE, sb(handle))
        self._expect_ok(kind, r, "close")

    # ------------------------------------------------- FileSystem verbs
    def create(self, path: str, data: bytes | str = b"") -> None:
        payload = data.encode() if isinstance(data, str) else bytes(data)

        def op():
            handle = self._open(path, PFLAG_WRITE | PFLAG_CREAT
                                | PFLAG_TRUNC)
            try:
                for off in range(0, len(payload), _CHUNK) or [0]:
                    chunk = payload[off:off + _CHUNK]
                    kind, r = self._request(
                        FXP_WRITE, sb(handle) + struct.pack("!Q", off)
                        + sb(chunk))
                    self._expect_ok(kind, r, f"write {path}")
            finally:
                self._close_handle(handle)
        self._observed("CREATE", path, op)

    def read(self, path: str) -> bytes:
        def op():
            handle = self._open(path, PFLAG_READ)
            out = io.BytesIO()
            try:
                offset = 0
                while True:
                    kind, r = self._request(
                        FXP_READ, sb(handle) + struct.pack("!QI", offset,
                                                           _CHUNK))
                    if kind == FXP_STATUS:
                        code, message = self._status(r)
                        if code == FX_EOF:
                            return out.getvalue()
                        raise SFTPError(f"read {path}: {message or code}",
                                        code=code)
                    data = r.string()
                    out.write(data)
                    offset += len(data)
            finally:
                self._close_handle(handle)
        return self._observed("READ", path, op)

    def read_text(self, path: str) -> str:
        return self.read(path).decode()

    def append(self, path: str, data: bytes | str) -> None:
        payload = data.encode() if isinstance(data, str) else bytes(data)

        def op():
            try:
                size = self.stat(path).size
            except SFTPError:
                size = 0
            handle = self._open(path, PFLAG_WRITE | PFLAG_CREAT
                                | PFLAG_APPEND)
            try:
                kind, r = self._request(
                    FXP_WRITE, sb(handle) + struct.pack("!Q", size)
                    + sb(payload))
                self._expect_ok(kind, r, f"append {path}")
            finally:
                self._close_handle(handle)
        self._observed("APPEND", path, op)

    def remove(self, path: str) -> None:
        def op():
            kind, r = self._request(FXP_REMOVE, ss(path))
            self._expect_ok(kind, r, f"remove {path}")
        self._observed("REMOVE", path, op)

    def rename(self, old: str, new: str) -> None:
        def op():
            kind, r = self._request(FXP_RENAME, ss(old) + ss(new))
            self._expect_ok(kind, r, f"rename {old}")
        self._observed("RENAME", f"{old}->{new}", op)

    def stat(self, path: str) -> FileInfo:
        def op():
            kind, r = self._request(FXP_STAT, ss(path))
            if kind != FXP_ATTRS:
                code, message = self._status(r)
                raise SFTPError(f"stat {path}: {message or code}",
                                code=code)
            size, is_dir, mtime = _parse_attrs(r)
            return FileInfo(name=posixpath.basename(path) or path,
                            size=size, is_dir=is_dir, mod_time=mtime)
        return self._observed("STAT", path, op)

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except SFTPError:
            return False

    def mkdir(self, path: str) -> None:
        def op():
            kind, r = self._request(
                FXP_MKDIR, ss(path) + struct.pack("!I", 0))
            self._expect_ok(kind, r, f"mkdir {path}")
        self._observed("MKDIR", path, op)

    def rmdir(self, path: str) -> None:
        def op():
            kind, r = self._request(FXP_RMDIR, ss(path))
            self._expect_ok(kind, r, f"rmdir {path}")
        self._observed("RMDIR", path, op)

    def read_dir(self, path: str = ".") -> list[FileInfo]:
        def op():
            kind, r = self._request(FXP_OPENDIR, ss(path))
            if kind != FXP_HANDLE:
                code, message = self._status(r)
                raise SFTPError(f"opendir {path}: {message or code}",
                                code=code)
            handle = r.string()
            out: list[FileInfo] = []
            try:
                while True:
                    kind, r2 = self._request(FXP_READDIR, sb(handle))
                    if kind == FXP_STATUS:
                        code, _ = self._status(r2)
                        if code == FX_EOF:
                            break
                        raise SFTPError(f"readdir {path}: {code}",
                                        code=code)
                    for _ in range(r2.uint32()):
                        name = r2.text()
                        r2.text()  # longname
                        size, is_dir, mtime = _parse_attrs(r2)
                        if name not in (".", ".."):
                            out.append(FileInfo(name=name, size=size,
                                                is_dir=is_dir,
                                                mod_time=mtime))
            finally:
                self._close_handle(handle)
            return sorted(out, key=lambda f: f.name)
        return self._observed("READ_DIR", path, op)

    def read_rows(self, path: str, kind: str | None = None) -> RowReader:
        return RowReader(self.read_text(path),
                         kind or ("csv" if path.endswith(".csv")
                                  else "json"))

    # -------------------------------------- paramiko-style alias verbs
    # (what ftp.SFTPFileSystem accepts as an injected client)
    def putfo(self, fileobj: Any, path: str) -> None:
        self.create(path, fileobj.read())

    def getfo(self, path: str, fileobj: Any) -> None:
        fileobj.write(self.read(path))

    def listdir(self, path: str = ".") -> list[str]:
        return [f.name for f in self.read_dir(path)]

    def health_check(self) -> dict[str, Any]:
        try:
            self.read_dir("/")
            return {"status": "UP",
                    "details": {"host": self.host, "port": self.port,
                                "user": self.username}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------ mini server

class _SFTPSession:
    """One authenticated channel's SFTP state over a jailed root."""

    def __init__(self, root: Path) -> None:
        self.root = root
        self.handles: dict[bytes, Any] = {}
        self.dir_handles: dict[bytes, list[Path]] = {}
        self.dir_sent: dict[bytes, bool] = {}
        self._n = 0

    def resolve(self, path: str) -> Path:
        clean = posixpath.normpath("/" + path.replace("\\", "/"))
        return (self.root / clean.lstrip("/")).resolve() \
            if clean != "/" else self.root

    def _jailed(self, path: str) -> Path:
        target = self.resolve(path)
        # is_relative_to, not startswith: /srv/jail2 must not pass a
        # /srv/jail jail, and resolve() already chased symlinks
        if target != self.root and not target.is_relative_to(self.root):
            raise SFTPError("outside root", code=FX_PERMISSION_DENIED)
        return target

    def new_handle(self) -> bytes:
        self._n += 1
        return b"h%d" % self._n

    # one SFTP request -> one response packet (without length prefix)
    def handle_packet(self, kind: int, body: bytes) -> bytes:  # noqa: C901
        r = Reader(body)
        req_id = r.uint32()

        def status(code: int, message: str = "") -> bytes:
            return bytes([FXP_STATUS]) + struct.pack("!I", req_id) \
                + struct.pack("!I", code) + ss(message) + ss("en")

        try:
            if kind == FXP_OPEN:
                path = self._jailed(r.text())
                pflags = r.uint32()
                if pflags & PFLAG_WRITE:
                    mode = "r+b" if not (pflags & PFLAG_TRUNC) else "wb"
                    if not path.exists():
                        if not pflags & PFLAG_CREAT:
                            return status(FX_NO_SUCH_FILE, "no such file")
                        mode = "wb"
                    elif pflags & PFLAG_APPEND:
                        mode = "r+b"
                else:
                    if not path.exists():
                        return status(FX_NO_SUCH_FILE, "no such file")
                    mode = "rb"
                handle = self.new_handle()
                self.handles[handle] = path.open(mode)
                return bytes([FXP_HANDLE]) + struct.pack("!I", req_id) \
                    + sb(handle)
            if kind == FXP_CLOSE:
                handle = r.string()
                fh = self.handles.pop(handle, None)
                if fh is not None:
                    fh.close()
                self.dir_handles.pop(handle, None)
                self.dir_sent.pop(handle, None)
                return status(FX_OK)
            if kind == FXP_READ:
                fh = self.handles.get(r.string())
                if fh is None:  # stale/forged handle: per-request error
                    return status(FX_FAILURE, "bad handle")
                offset = r.uint64()
                length = r.uint32()
                fh.seek(offset)
                data = fh.read(length)
                if not data:
                    return status(FX_EOF, "eof")
                return bytes([FXP_DATA]) + struct.pack("!I", req_id) \
                    + sb(data)
            if kind == FXP_WRITE:
                fh = self.handles.get(r.string())
                if fh is None:
                    return status(FX_FAILURE, "bad handle")
                offset = r.uint64()
                data = r.string()
                fh.seek(offset)
                fh.write(data)
                return status(FX_OK)
            if kind in (FXP_STAT, FXP_LSTAT):
                path = self._jailed(r.text())
                if not path.exists():
                    return status(FX_NO_SUCH_FILE, "no such file")
                st = path.stat()
                return bytes([FXP_ATTRS]) + struct.pack("!I", req_id) \
                    + _attrs(st.st_size, path.is_dir(), st.st_mtime)
            if kind == FXP_OPENDIR:
                path = self._jailed(r.text())
                if not path.is_dir():
                    return status(FX_NO_SUCH_FILE, "not a directory")
                handle = self.new_handle()
                self.dir_handles[handle] = sorted(path.iterdir())
                self.dir_sent[handle] = False
                return bytes([FXP_HANDLE]) + struct.pack("!I", req_id) \
                    + sb(handle)
            if kind == FXP_READDIR:
                handle = r.string()
                if handle not in self.dir_handles:
                    return status(FX_FAILURE, "bad handle")
                if self.dir_sent[handle]:
                    return status(FX_EOF, "eof")
                self.dir_sent[handle] = True
                entries = self.dir_handles[handle]
                out = bytes([FXP_NAME]) + struct.pack(
                    "!II", req_id, len(entries))
                for entry in entries:
                    st = entry.stat()
                    out += ss(entry.name) + ss(entry.name) \
                        + _attrs(st.st_size, entry.is_dir(), st.st_mtime)
                return out
            if kind == FXP_REMOVE:
                path = self._jailed(r.text())
                if not path.is_file():
                    return status(FX_NO_SUCH_FILE, "no such file")
                path.unlink()
                return status(FX_OK)
            if kind == FXP_RENAME:
                old = self._jailed(r.text())
                new = self._jailed(r.text())
                if not old.exists():
                    return status(FX_NO_SUCH_FILE, "no such file")
                old.rename(new)
                return status(FX_OK)
            if kind == FXP_MKDIR:
                self._jailed(r.text()).mkdir(parents=False,
                                             exist_ok=False)
                return status(FX_OK)
            if kind == FXP_RMDIR:
                path = self._jailed(r.text())
                if not path.is_dir():
                    return status(FX_NO_SUCH_FILE, "no such dir")
                path.rmdir()
                return status(FX_OK)
        except SFTPError as exc:
            return status(exc.code, str(exc))
        except OSError as exc:
            return status(FX_FAILURE, str(exc))
        return status(FX_FAILURE, f"unsupported request {kind}")


class _SSHHandler(socketserver.BaseRequestHandler):
    @property
    def mini(self) -> "MiniSFTPServer":
        return self.server.mini  # type: ignore[attr-defined]

    def handle(self) -> None:
        transport = SSHServerTransport(self.request,
                                       host_key=self.mini.host_key,
                                       users=self.mini.users)
        try:
            transport.handshake()
            channel, subsystem = transport.accept_subsystem()
            if subsystem != "sftp":
                return
            session = _SFTPSession(self.mini.root)
            buf = b""
            # INIT/VERSION then the request loop
            while True:
                chunk = transport.recv_channel_data()
                # replenish the client's send window as we consume —
                # without this, uploads stall once the initial window
                # (1 GiB) is spent on a long-lived connection
                from .ssh_transport import MSG_CHANNEL_WINDOW_ADJUST
                transport.send_packet(
                    bytes([MSG_CHANNEL_WINDOW_ADJUST])
                    + struct.pack("!II", channel, len(chunk)))
                buf += chunk
                while len(buf) >= 4:
                    (length,) = struct.unpack("!I", buf[:4])
                    if len(buf) < 4 + length:
                        break
                    body = buf[4:4 + length]
                    buf = buf[4 + length:]
                    kind = body[0]
                    if kind == FXP_INIT:
                        reply = bytes([FXP_VERSION]) + struct.pack("!I", 3)
                    else:
                        reply = session.handle_packet(kind, body[1:])
                    transport.send_channel_data(
                        channel, struct.pack("!I", len(reply)) + reply)
        except (SSHError, SSHAuthError, ConnectionError, OSError):
            return


class MiniSFTPServer:
    """A real SSH server (from-spec transport, verified password auth,
    ed25519 host key) serving SFTP v3 out of a jailed directory."""

    def __init__(self, root: str | Path, host: str = "127.0.0.1",
                 port: int = 0, *, users: dict[str, str] | None = None
                 ) -> None:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey)
        self.root = Path(root).resolve()
        self.root.mkdir(parents=True, exist_ok=True)
        self.host = host
        self.port = port
        self.users = dict(users or {"demo": "demo"})
        self.host_key = Ed25519PrivateKey.generate()
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None

    def host_public_key(self) -> bytes:
        from cryptography.hazmat.primitives import serialization
        return self.host_key.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

    def start(self) -> None:
        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = TCP((self.host, self.port), _SSHHandler)
        self._server.mini = self  # the handler reads this back
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="mini-sftp")
        self._thread.start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
