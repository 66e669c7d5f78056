"""SSH2 transport implemented from the RFCs, client and server halves (the
port's copy of ``gofr_tpu/datasource/ssh_transport.py``).

The reference's SFTP module rides a Go SSH stack (datasource/file/sftp
over pkg/sftp + x/crypto/ssh); this is the equivalent transport built
from the specification with only the stdlib and the ``cryptography``
primitives already in the image:

- RFC 4253 binary packet protocol: version exchange, KEXINIT
  negotiation, curve25519-sha256 key exchange, ssh-ed25519 host keys,
  aes128-ctr encryption, hmac-sha2-256 integrity, RFC 4253 §7.2 key
  derivation.
- RFC 4252 password authentication (client sends, server verifies).
- RFC 4254 connection protocol: one "session" channel carrying a
  subsystem (SFTP rides on top, :mod:`.sftp_wire`), with window
  accounting.

One algorithm per slot, deliberately: the negotiation lists are real,
but both halves of this framework offer exactly the modern suite
above, which also interoperates with OpenSSH defaults.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import socket
import struct
from typing import Any

VERSION_STRING = "SSH-2.0-gofrssh_0.1"

MSG_DISCONNECT = 1
MSG_SERVICE_REQUEST = 5
MSG_SERVICE_ACCEPT = 6
MSG_KEXINIT = 20
MSG_NEWKEYS = 21
MSG_KEX_ECDH_INIT = 30
MSG_KEX_ECDH_REPLY = 31
MSG_USERAUTH_REQUEST = 50
MSG_USERAUTH_FAILURE = 51
MSG_USERAUTH_SUCCESS = 52
MSG_CHANNEL_OPEN = 90
MSG_CHANNEL_OPEN_CONFIRMATION = 91
MSG_CHANNEL_OPEN_FAILURE = 92
MSG_CHANNEL_WINDOW_ADJUST = 93
MSG_CHANNEL_DATA = 94
MSG_CHANNEL_EOF = 96
MSG_CHANNEL_CLOSE = 97
MSG_CHANNEL_REQUEST = 98
MSG_CHANNEL_SUCCESS = 99
MSG_CHANNEL_FAILURE = 100

KEX_ALG = "curve25519-sha256"
HOSTKEY_ALG = "ssh-ed25519"
CIPHER_ALG = "aes128-ctr"
MAC_ALG = "hmac-sha2-256"

_WINDOW = 1 << 30
_MAX_PACKET = 1 << 15


class SSHError(Exception):
    pass


class SSHAuthError(SSHError):
    pass


# ----------------------------------------------------------- wire atoms

def sb(data: bytes) -> bytes:
    """SSH string."""
    return struct.pack("!I", len(data)) + data


def ss(text: str) -> bytes:
    return sb(text.encode())


def mpint(n: int) -> bytes:
    if n == 0:
        return sb(b"")
    raw = n.to_bytes((n.bit_length() + 8) // 8, "big")  # leading 0 bit
    return sb(raw)


class Reader:
    """Sequential parser over one payload."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def byte(self) -> int:
        self.off += 1
        return self.data[self.off - 1]

    def boolean(self) -> bool:
        return self.byte() != 0

    def uint32(self) -> int:
        (v,) = struct.unpack_from("!I", self.data, self.off)
        self.off += 4
        return v

    def uint64(self) -> int:
        (v,) = struct.unpack_from("!Q", self.data, self.off)
        self.off += 8
        return v

    def string(self) -> bytes:
        n = self.uint32()
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def text(self) -> str:
        return self.string().decode()

    def namelist(self) -> list[str]:
        raw = self.text()
        return raw.split(",") if raw else []


# ------------------------------------------------------------- transport

class _Stream:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._buf = b""

    def exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise SSHError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def line(self) -> bytes:
        while b"\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise SSHError("connection closed during version exchange")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\n")
        return line.rstrip(b"\r")


def _kexinit_payload() -> bytes:
    lists = [
        KEX_ALG, HOSTKEY_ALG, CIPHER_ALG, CIPHER_ALG, MAC_ALG, MAC_ALG,
        "none", "none", "", "",
    ]
    out = bytes([MSG_KEXINIT]) + os.urandom(16)
    for names in lists:
        out += ss(names)
    out += b"\x00" + struct.pack("!I", 0)
    return out


def _derive(k: bytes, h: bytes, tag: bytes, session_id: bytes,
            length: int) -> bytes:
    out = hashlib.sha256(k + h + tag + session_id).digest()
    while len(out) < length:
        out += hashlib.sha256(k + h + out).digest()
    return out[:length]


class _Direction:
    """One flow (c→s or s→c): cipher stream + MAC + sequence number."""

    def __init__(self, key: bytes, iv: bytes, mac_key: bytes) -> None:
        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes)
        self._cipher = Cipher(algorithms.AES(key), modes.CTR(iv))
        self.enc = self._cipher.encryptor()
        self.dec = self._cipher.decryptor()
        self.mac_key = mac_key
        self.seq = 0

    def mac(self, packet: bytes) -> bytes:
        data = struct.pack("!I", self.seq) + packet
        return hmac_mod.new(self.mac_key, data, hashlib.sha256).digest()


class SSHTransport:
    """Post-handshake packet transport shared by client and server."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.stream = _Stream(sock)
        self.session_id = b""
        self._out: _Direction | None = None
        self._in: _Direction | None = None
        self._out_seq = 0
        self._in_seq = 0
        self._peer_window = _WINDOW  # replaced by the channel reply
        self._pending_data: list[bytes] = []

    # ------------------------------------------------------ raw packets
    def send_packet(self, payload: bytes) -> None:
        block = 16 if self._out else 8
        pad = block - ((5 + len(payload)) % block)
        if pad < 4:
            pad += block
        packet = struct.pack("!IB", 1 + len(payload) + pad, pad) \
            + payload + os.urandom(pad)
        if self._out is None:
            self.sock.sendall(packet)
            self._out_seq += 1
            return
        self._out.seq = self._out_seq
        mac = self._out.mac(packet)
        self.sock.sendall(self._out.enc.update(packet) + mac)
        self._out_seq += 1

    def recv_packet(self) -> bytes:
        if self._in is None:
            head = self.stream.exactly(4)
            (length,) = struct.unpack("!I", head)
            if not 5 <= length <= 35000:  # RFC 4253 §6.1
                raise SSHError(f"packet length {length} out of bounds")
            body = self.stream.exactly(length)
            self._in_seq += 1
            pad = body[0]
            return body[1:length - pad]
        head = self._in.dec.update(self.stream.exactly(16))
        (length,) = struct.unpack("!I", head[:4])
        # bound before allocating: length is wire-supplied and the MAC
        # is only checked after the remainder is read.  RFC 4253 §6.1:
        # minimum total packet is one cipher block (16), i.e. a length
        # field of 12, and receivers must handle up to 35000 total.
        if not 12 <= length <= 35000:
            raise SSHError(f"packet length {length} out of bounds")
        rest = self._in.dec.update(self.stream.exactly(length - 12))
        mac = self.stream.exactly(32)
        packet = head + rest
        self._in.seq = self._in_seq
        if not hmac_mod.compare_digest(self._in.mac(packet), mac):
            raise SSHError("MAC verification failed")
        self._in_seq += 1
        pad = packet[4]
        return packet[5:4 + length - pad]

    # --------------------------------------------------------- handshake
    def _exchange_versions(self, ours: str) -> str:
        self.sock.sendall((ours + "\r\n").encode())
        while True:
            line = self.stream.line()
            if line.startswith(b"SSH-"):
                return line.decode("latin-1")

    def _activate(self, k_mp: bytes, h: bytes, *, client: bool) -> None:
        if not self.session_id:
            self.session_id = h
        sid = self.session_id

        def dk(tag: bytes, length: int) -> bytes:
            return _derive(k_mp, h, tag, sid, length)

        c2s = _Direction(dk(b"C", 16), dk(b"A", 16), dk(b"E", 32))
        s2c = _Direction(dk(b"D", 16), dk(b"B", 16), dk(b"F", 32))
        self._out, self._in = (c2s, s2c) if client else (s2c, c2s)

    def _check_kexinit(self, payload: bytes) -> None:
        r = Reader(payload)
        if r.byte() != MSG_KEXINIT:
            raise SSHError("expected KEXINIT")
        r.off += 16  # cookie
        kex, hostkey = r.namelist(), r.namelist()
        c2s_ciph, s2c_ciph = r.namelist(), r.namelist()
        c2s_mac, s2c_mac = r.namelist(), r.namelist()
        if (KEX_ALG not in kex or HOSTKEY_ALG not in hostkey
                or CIPHER_ALG not in c2s_ciph or CIPHER_ALG not in s2c_ciph
                or MAC_ALG not in c2s_mac or MAC_ALG not in s2c_mac):
            raise SSHError(
                f"no common algorithms (peer kex={kex[:3]}, "
                f"hostkey={hostkey[:3]})")

    # ---------------------------------------------------------- channel
    def _consume(self, payload: bytes) -> bytes | None:
        """Account one incoming packet; -> DATA bytes if it carried
        channel data, else None. Raises on close/disconnect."""
        kind = payload[0]
        if kind == MSG_CHANNEL_DATA:
            r = Reader(payload[1:])
            r.uint32()
            return r.string()
        if kind == MSG_CHANNEL_WINDOW_ADJUST:
            r = Reader(payload[1:])
            r.uint32()
            self._peer_window += r.uint32()
            return None
        if kind in (MSG_CHANNEL_CLOSE, MSG_DISCONNECT):
            raise SSHError("channel closed by peer")
        # globals (e.g. hostkeys-00@openssh.com), debug, ignore, EOF
        return None

    def open_session_channel(self) -> int:
        """Client side: -> recipient (server) channel id."""
        self.send_packet(bytes([MSG_CHANNEL_OPEN]) + ss("session")
                         + struct.pack("!III", 0, _WINDOW, _MAX_PACKET))
        while True:  # sshd may interleave global requests here
            payload = self.recv_packet()
            kind = payload[0]
            if kind == MSG_CHANNEL_OPEN_CONFIRMATION:
                r = Reader(payload[1:])
                r.uint32()  # our id echo
                sender = r.uint32()
                self._peer_window = r.uint32()
                return sender
            if kind == MSG_CHANNEL_OPEN_FAILURE:
                raise SSHError("channel open refused")
            self._consume(payload)

    def request_subsystem(self, channel: int, name: str) -> None:
        self.send_packet(bytes([MSG_CHANNEL_REQUEST])
                         + struct.pack("!I", channel) + ss("subsystem")
                         + b"\x01" + ss(name))
        while True:
            payload = self.recv_packet()
            kind = payload[0]
            if kind == MSG_CHANNEL_SUCCESS:
                return
            if kind == MSG_CHANNEL_FAILURE:
                raise SSHError(f"subsystem {name!r} refused")
            self._consume(payload)

    def send_channel_data(self, channel: int, data: bytes) -> None:
        for i in range(0, len(data), _MAX_PACKET - 1024):
            chunk = data[i:i + _MAX_PACKET - 1024]
            # flow control: wait for WINDOW_ADJUST when the peer's
            # window is exhausted (data that arrives meanwhile queues
            # for recv_channel_data — the protocols above are strictly
            # request/response, so this stays bounded)
            while self._peer_window < len(chunk):
                got = self._consume(self.recv_packet())
                if got is not None:
                    self._pending_data.append(got)
            self._peer_window -= len(chunk)
            self.send_packet(bytes([MSG_CHANNEL_DATA])
                             + struct.pack("!I", channel) + sb(chunk))

    def recv_channel_data(self) -> bytes:
        """Next CHANNEL_DATA payload; window/ignore frames are consumed."""
        if self._pending_data:
            return self._pending_data.pop(0)
        while True:
            got = self._consume(self.recv_packet())
            if got is not None:
                return got


# ---------------------------------------------------------------- client

class SSHClientTransport(SSHTransport):
    def handshake(self, *, username: str, password: str,
                  expected_host_key: bytes | None = None,
                  insecure_skip_host_key: bool = False) -> None:
        """Version exchange → kex → NEWKEYS → password auth.

        Host-key policy mirrors x/crypto/ssh's HostKeyCallback: the
        caller must either pin ``expected_host_key`` or explicitly opt
        in to an unauthenticated connection — the Ed25519 signature
        alone only proves the peer owns *some* key, so a silent default
        would hand the password to any man in the middle."""
        if expected_host_key is None and not insecure_skip_host_key:
            raise SSHError(
                "no host key policy: pass expected_host_key=... or "
                "insecure_skip_host_key=True (MITM-able; test only)")
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PrivateKey)
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PublicKey)
        from cryptography.hazmat.primitives import serialization

        v_s = self._exchange_versions(VERSION_STRING)
        i_c = _kexinit_payload()
        self.send_packet(i_c)
        i_s = self.recv_packet()
        self._check_kexinit(i_s)

        eph = X25519PrivateKey.generate()
        q_c = eph.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        self.send_packet(bytes([MSG_KEX_ECDH_INIT]) + sb(q_c))

        r = Reader(self.recv_packet())
        if r.byte() != MSG_KEX_ECDH_REPLY:
            raise SSHError("expected KEX_ECDH_REPLY")
        k_s = r.string()
        q_s = r.string()
        signature_blob = r.string()

        kr = Reader(k_s)
        if kr.text() != HOSTKEY_ALG:
            raise SSHError("unexpected host key type")
        host_pub_raw = kr.string()
        if expected_host_key is not None \
                and host_pub_raw != expected_host_key:
            raise SSHError("host key mismatch (possible MITM)")

        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PublicKey)
        shared = eph.exchange(X25519PublicKey.from_public_bytes(q_s))
        k_int = int.from_bytes(shared, "big")
        h = hashlib.sha256(
            ss(VERSION_STRING) + ss(v_s) + sb(i_c) + sb(i_s)
            + sb(k_s) + sb(q_c) + sb(q_s) + mpint(k_int)).digest()

        sr = Reader(signature_blob)
        if sr.text() != HOSTKEY_ALG:
            raise SSHError("unexpected signature type")
        raw_sig = sr.string()
        try:
            Ed25519PublicKey.from_public_bytes(host_pub_raw).verify(
                raw_sig, h)
        except Exception as exc:
            raise SSHError(f"host signature invalid: {exc}") from exc

        self.send_packet(bytes([MSG_NEWKEYS]))
        if self.recv_packet()[0] != MSG_NEWKEYS:
            raise SSHError("expected NEWKEYS")
        self._activate(mpint(k_int), h, client=True)

        # ------------------------------------------------------- auth
        self.send_packet(bytes([MSG_SERVICE_REQUEST]) + ss("ssh-userauth"))
        if self.recv_packet()[0] != MSG_SERVICE_ACCEPT:
            raise SSHError("userauth service refused")
        self.send_packet(
            bytes([MSG_USERAUTH_REQUEST]) + ss(username)
            + ss("ssh-connection") + ss("password") + b"\x00"
            + ss(password))
        kind = self.recv_packet()[0]
        if kind != MSG_USERAUTH_SUCCESS:
            raise SSHAuthError("password authentication failed")


# ---------------------------------------------------------------- server

class SSHServerTransport(SSHTransport):
    def __init__(self, sock: socket.socket, *, host_key: Any,
                 users: dict[str, str]) -> None:
        super().__init__(sock)
        self.host_key = host_key  # Ed25519PrivateKey
        self.users = users
        self.username = ""

    def handshake(self) -> None:
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PrivateKey, X25519PublicKey)
        from cryptography.hazmat.primitives import serialization

        v_c = self._exchange_versions(VERSION_STRING)
        i_s = _kexinit_payload()
        self.send_packet(i_s)
        i_c = self.recv_packet()
        self._check_kexinit(i_c)

        r = Reader(self.recv_packet())
        if r.byte() != MSG_KEX_ECDH_INIT:
            raise SSHError("expected KEX_ECDH_INIT")
        q_c = r.string()

        eph = X25519PrivateKey.generate()
        q_s = eph.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        shared = eph.exchange(X25519PublicKey.from_public_bytes(q_c))
        k_int = int.from_bytes(shared, "big")

        host_pub = self.host_key.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        k_s = ss(HOSTKEY_ALG) + sb(host_pub)
        h = hashlib.sha256(
            ss(v_c) + ss(VERSION_STRING) + sb(i_c) + sb(i_s)
            + sb(k_s) + sb(q_c) + sb(q_s) + mpint(k_int)).digest()
        signature = ss(HOSTKEY_ALG) + sb(self.host_key.sign(h))

        self.send_packet(bytes([MSG_KEX_ECDH_REPLY]) + sb(k_s) + sb(q_s)
                         + sb(signature))
        self.send_packet(bytes([MSG_NEWKEYS]))
        if self.recv_packet()[0] != MSG_NEWKEYS:
            raise SSHError("expected NEWKEYS")
        self._activate(mpint(k_int), h, client=False)

        # ------------------------------------------------------- auth
        r = Reader(self.recv_packet())
        if r.byte() != MSG_SERVICE_REQUEST or r.text() != "ssh-userauth":
            raise SSHError("expected ssh-userauth service request")
        self.send_packet(bytes([MSG_SERVICE_ACCEPT]) + ss("ssh-userauth"))

        for _ in range(8):  # a few tries, like sshd MaxAuthTries
            r = Reader(self.recv_packet())
            if r.byte() != MSG_USERAUTH_REQUEST:
                raise SSHError("expected USERAUTH_REQUEST")
            username = r.text()
            r.text()  # service
            method = r.text()
            if method == "password":
                r.boolean()
                password = r.text()
                expected = self.users.get(username)
                if expected is not None and hmac_mod.compare_digest(
                        expected.encode(), password.encode()):
                    self.username = username
                    self.send_packet(bytes([MSG_USERAUTH_SUCCESS]))
                    return
            self.send_packet(bytes([MSG_USERAUTH_FAILURE])
                             + ss("password") + b"\x00")
        raise SSHAuthError("too many auth failures")

    def accept_subsystem(self) -> tuple[int, str]:
        """-> (client channel id, subsystem name) after confirming the
        session channel."""
        r = Reader(self.recv_packet())
        if r.byte() != MSG_CHANNEL_OPEN or r.text() != "session":
            raise SSHError("expected session CHANNEL_OPEN")
        client_channel = r.uint32()
        self.send_packet(bytes([MSG_CHANNEL_OPEN_CONFIRMATION])
                         + struct.pack("!IIII", client_channel, 0,
                                       _WINDOW, _MAX_PACKET))
        r = Reader(self.recv_packet())
        if r.byte() != MSG_CHANNEL_REQUEST:
            raise SSHError("expected CHANNEL_REQUEST")
        r.uint32()
        if r.text() != "subsystem":
            raise SSHError("only subsystem requests supported")
        want_reply = r.boolean()
        name = r.text()
        if want_reply:
            self.send_packet(bytes([MSG_CHANNEL_SUCCESS])
                             + struct.pack("!I", client_channel))
        return client_channel, name
