"""FTP-backed FileSystem (reference datasource/file/ftp) over the
stdlib ``ftplib`` wire client, plus an in-process mini FTP server so
tests drive real protocol bytes (the broker-test philosophy of
pubsub/nats.py applied to file transfer). The port's copy of
``gofr_tpu/datasource/ftp.py``.

SFTP (reference datasource/file/sftp) needs an SSH stack that is not
in this image; :class:`SFTPFileSystem` ships the same surface and
raises a clear error at connect unless given a ready client object
(dependency-injected, mockable — the reference test strategy)."""

from __future__ import annotations

import ftplib
import io
import threading
import time
from typing import Any

from . import Instrumented
from .file_store import FileError, FileInfo, RowReader


class FTPFileSystem(Instrumented):
    metric = "app_file_stats"
    log_tag = "FTP"

    def __init__(self, host: str = "127.0.0.1", port: int = 21,
                 user: str = "anonymous", password: str = "",
                 timeout: float = 10.0) -> None:
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.timeout = timeout
        self._ftp: ftplib.FTP | None = None
        self._lock = threading.RLock()

    def connect(self) -> None:
        ftp = ftplib.FTP()
        ftp.connect(self.host, self.port, timeout=self.timeout)
        ftp.login(self.user, self.password)
        self._ftp = ftp
        if self.logger is not None:
            self.logger.info(f"FTP connected {self.host}:{self.port}")

    def _require(self) -> ftplib.FTP:
        if self._ftp is None:
            raise FileError("FTP not connected")
        return self._ftp

    # ------------------------------------------------ FileSystem surface
    def create(self, path: str, data: bytes | str = b"") -> None:
        payload = data.encode() if isinstance(data, str) else bytes(data)
        def op():
            with self._lock:
                self._require().storbinary(f"STOR {path}",
                                           io.BytesIO(payload))
        self._observed("CREATE", path, op)

    def read(self, path: str) -> bytes:
        def op():
            buf = io.BytesIO()
            with self._lock:
                self._require().retrbinary(f"RETR {path}", buf.write)
            return buf.getvalue()
        return self._observed("READ", path, op)

    def read_text(self, path: str) -> str:
        return self.read(path).decode()

    def append(self, path: str, data: bytes | str) -> None:
        payload = data.encode() if isinstance(data, str) else bytes(data)
        def op():
            with self._lock:
                self._require().storbinary(f"APPE {path}",
                                           io.BytesIO(payload))
        self._observed("APPEND", path, op)

    def remove(self, path: str) -> None:
        def op():
            with self._lock:
                self._require().delete(path)
        self._observed("REMOVE", path, op)

    def rename(self, old: str, new: str) -> None:
        def op():
            with self._lock:
                self._require().rename(old, new)
        self._observed("RENAME", f"{old}->{new}", op)

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except Exception:
            return False

    def stat(self, path: str) -> FileInfo:
        def op():
            with self._lock:
                size = self._require().size(path)
            if size is None:
                raise FileError(f"no such file: {path}")
            return FileInfo(name=path.rsplit("/", 1)[-1], size=size,
                            is_dir=False, mod_time=time.time())
        return self._observed("STAT", path, op)

    def mkdir(self, path: str) -> None:
        def op():
            with self._lock:
                self._require().mkd(path)
        self._observed("MKDIR", path, op)

    def read_dir(self, path: str = ".") -> list[FileInfo]:
        def op():
            with self._lock:
                names = self._require().nlst(path)
            return [FileInfo(name=n.rsplit("/", 1)[-1], size=0,
                             is_dir=n.endswith("/"), mod_time=0.0)
                    for n in names]
        return self._observed("READ_DIR", path, op)

    def read_rows(self, path: str, kind: str | None = None) -> RowReader:
        text = self.read_text(path)
        if kind is None:
            kind = "csv" if path.endswith(".csv") else "json"
        return RowReader(text, kind)

    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                self._require().voidcmd("NOOP")
            return {"status": "UP",
                    "details": {"backend": "ftp",
                                "addr": f"{self.host}:{self.port}"}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        if self._ftp is not None:
            try:
                self._ftp.quit()
            except Exception:
                pass
            self._ftp = None


class SFTPFileSystem(FTPFileSystem):
    """Same surface over an injected SFTP client (paramiko-style:
    open/put/get/listdir/remove/rename/mkdir/stat). The SSH stack is
    not baked into this image, so the client arrives from outside —
    production injects paramiko, tests inject a fake."""

    log_tag = "SFTP"

    def __init__(self, client: Any = None, **kw: Any) -> None:
        super().__init__(**kw)
        self._client = client

    def connect(self) -> None:
        if self._client is None:
            raise FileError(
                "SFTP needs an injected client (paramiko SFTPClient-like); "
                "none provided and no SSH stack is bundled")

    def create(self, path: str, data: bytes | str = b"") -> None:
        payload = data.encode() if isinstance(data, str) else bytes(data)
        self._observed("CREATE", path,
                       lambda: self._client.putfo(io.BytesIO(payload), path))

    def read(self, path: str) -> bytes:
        def op():
            buf = io.BytesIO()
            self._client.getfo(path, buf)
            return buf.getvalue()
        return self._observed("READ", path, op)

    def remove(self, path: str) -> None:
        self._observed("REMOVE", path, lambda: self._client.remove(path))

    def rename(self, old: str, new: str) -> None:
        self._observed("RENAME", f"{old}->{new}",
                       lambda: self._client.rename(old, new))

    def read_dir(self, path: str = ".") -> list[FileInfo]:
        def op():
            return [FileInfo(name=n, size=0, is_dir=False, mod_time=0.0)
                    for n in self._client.listdir(path)]
        return self._observed("READ_DIR", path, op)

    def health_check(self) -> dict[str, Any]:
        status = "UP" if self._client is not None else "DOWN"
        return {"status": status, "details": {"backend": "sftp"}}


# ---------------------------------------------------------------- server
class MiniFTPServer:
    """Minimal threaded FTP server for tests: USER/PASS, TYPE, PASV,
    STOR/APPE/RETR/DELE/RNFR+RNTO, SIZE, NLST, MKD, NOOP, QUIT over an
    in-memory tree."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        import socket
        self.host = host
        self._files: dict[str, bytes] = {}
        self._dirs: set[str] = set()
        self._lock = threading.Lock()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn) -> None:
        import socket
        # each reply is its own small write ("150", then "226" after the
        # data connection): without TCP_NODELAY the second waits for the
        # client's delayed ACK, about 40 ms a transfer over loopback
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def send(line: str) -> None:
            conn.sendall((line + "\r\n").encode())

        data_listener: socket.socket | None = None
        rename_from: str | None = None
        send("220 mini-ftp ready")
        reader = conn.makefile("rb")
        try:
            while True:
                raw = reader.readline()
                if not raw:
                    break
                parts = raw.decode().strip().split(" ", 1)
                cmd = parts[0].upper()
                arg = parts[1] if len(parts) > 1 else ""
                if cmd == "USER":
                    send("331 password please")
                elif cmd == "PASS":
                    send("230 logged in")
                elif cmd == "TYPE":
                    send("200 type set")
                elif cmd == "NOOP":
                    send("200 ok")
                elif cmd == "PASV":
                    data_listener = socket.socket()
                    data_listener.bind((self.host, 0))
                    data_listener.listen(1)
                    p = data_listener.getsockname()[1]
                    h = self.host.replace(".", ",")
                    send(f"227 entering passive ({h},{p >> 8},{p & 255})")
                elif cmd in ("STOR", "APPE"):
                    if data_listener is None:
                        send("425 use PASV first")
                        continue
                    send("150 ok to send")
                    dconn, _ = data_listener.accept()
                    chunks = []
                    while True:
                        chunk = dconn.recv(65536)
                        if not chunk:
                            break
                        chunks.append(chunk)
                    dconn.close()
                    data_listener.close()
                    data_listener = None
                    with self._lock:
                        if cmd == "APPE":
                            prev = self._files.get(arg, b"")
                            self._files[arg] = prev + b"".join(chunks)
                        else:
                            self._files[arg] = b"".join(chunks)
                    send("226 stored")
                elif cmd == "RETR":
                    with self._lock:
                        data = self._files.get(arg)
                    if data is None:
                        send("550 no such file")
                        continue
                    if data_listener is None:
                        send("425 use PASV first")
                        continue
                    send("150 opening data connection")
                    dconn, _ = data_listener.accept()
                    dconn.sendall(data)
                    dconn.close()
                    data_listener.close()
                    data_listener = None
                    send("226 transfer complete")
                elif cmd == "SIZE":
                    with self._lock:
                        data = self._files.get(arg)
                    if data is None:
                        send("550 no such file")
                    else:
                        send(f"213 {len(data)}")
                elif cmd == "DELE":
                    with self._lock:
                        existed = self._files.pop(arg, None) is not None
                    send("250 deleted" if existed else "550 no such file")
                elif cmd == "RNFR":
                    rename_from = arg
                    send("350 ready for RNTO")
                elif cmd == "RNTO":
                    with self._lock:
                        if rename_from in self._files:
                            self._files[arg] = self._files.pop(rename_from)
                            send("250 renamed")
                        else:
                            send("550 no such file")
                    rename_from = None
                elif cmd == "MKD":
                    with self._lock:
                        self._dirs.add(arg)
                    send(f'257 "{arg}" created')
                elif cmd == "NLST":
                    if data_listener is None:
                        send("425 use PASV first")
                        continue
                    prefix = "" if arg in ("", ".") else arg.rstrip("/") + "/"
                    with self._lock:
                        names = [k for k in sorted(self._files)
                                 if k.startswith(prefix)]
                    send("150 here comes the listing")
                    dconn, _ = data_listener.accept()
                    dconn.sendall("".join(f"{n}\r\n" for n in names).encode())
                    dconn.close()
                    data_listener.close()
                    data_listener = None
                    send("226 done")
                elif cmd == "QUIT":
                    send("221 bye")
                    break
                else:
                    send(f"502 {cmd} not implemented")
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
