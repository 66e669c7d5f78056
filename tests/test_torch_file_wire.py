"""The port's FTP, NATS-KV and SFTP stores (``datasource/ftp.py``,
``nats_kv.py``, ``ssh_transport.py``, ``sftp_wire.py``) against the JAX
package's: every case of ``TestFTP`` / ``TestSFTP`` in
``tests/test_remote_file_stores.py``, of ``tests/test_nats_kv.py`` and of
``tests/test_sftp_wire.py``, and the SFTP byte-dribble case of
``tests/test_wire_fragmentation.py``, run three ways: the port's client on
the port's server, the port's client on JAX's server and JAX's client on
the port's server (``torch_wire.PAIRS``), over real loopback sockets (the
SSH cases include curve25519 key exchange, aes128-ctr + hmac-sha2-256
and password auth between the two packages). Then one scripted session
per protocol, in both cross directions, gives the same files, listings,
values, tombstones and typed errors as JAX's client on JAX's server; and
each client records its ``app_<store>_stats`` histogram.
"""

import asyncio
import io
import threading

import pytest

from .torch_wire import PAIR_IDS, PAIRS, Pair, side_module

CROSS = [("port", "jax"), ("jax", "port")]
CROSS_IDS = ["port-client-jax-server", "jax-client-port-server"]


# ------------------------------------------------------------------ FTP
class TestFTP:
    """``TestFTP`` of ``tests/test_remote_file_stores.py``."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("ftp", request.param)

    @pytest.fixture()
    def server(self, m):
        server = m.MiniFTPServer()
        server.start()
        yield server
        server.close()

    def test_roundtrip_over_the_wire(self, m, server):
        fs = m.FTPFileSystem(port=server.port, user="u", password="p")
        fs.connect()
        try:
            fs.create("report.txt", "hello ftp")
            assert fs.read_text("report.txt") == "hello ftp"
            fs.append("report.txt", "!")
            assert fs.read_text("report.txt") == "hello ftp!"
            assert fs.stat("report.txt").size == 10
            assert fs.exists("report.txt")
            fs.rename("report.txt", "report2.txt")
            assert not fs.exists("report.txt")
            names = [i.name for i in fs.read_dir()]
            assert names == ["report2.txt"]
            fs.remove("report2.txt")
            assert not fs.exists("report2.txt")
            assert fs.health_check()["status"] == "UP"
        finally:
            fs.close()

    def test_rows_over_ftp(self, m, server):
        fs = m.FTPFileSystem(port=server.port)
        fs.connect()
        try:
            fs.create("data.csv", "a,b\n5,6\n")
            assert list(fs.read_rows("data.csv")) == [{"a": "5", "b": "6"}]
        finally:
            fs.close()

    def test_health_down_after_server_gone(self, m, server):
        fs = m.FTPFileSystem(port=server.port)
        fs.connect()
        server.close()
        assert fs.health_check()["status"] in ("UP", "DOWN")
        fs.close()
        assert fs.health_check()["status"] == "DOWN"


class FakeSFTP:
    """A paramiko-shaped client held in memory."""

    def __init__(self):
        self.blobs = {}

    def putfo(self, fobj, path):
        self.blobs[path] = fobj.read()

    def getfo(self, path, fobj):
        fobj.write(self.blobs[path])

    def listdir(self, path):
        return sorted(self.blobs)

    def remove(self, path):
        del self.blobs[path]

    def rename(self, old, new):
        self.blobs[new] = self.blobs.pop(old)


class TestSFTPShim:
    """``TestSFTP`` of ``tests/test_remote_file_stores.py``: the
    ``SFTPFileSystem`` shim over an injected client, on both packages."""

    @pytest.fixture(params=["port", "jax"])
    def ftp(self, request):
        return side_module(request.param, "ftp")

    def test_requires_injected_client(self, ftp):
        from_side = ftp.FileError
        fs = ftp.SFTPFileSystem()
        with pytest.raises(from_side, match="injected client"):
            fs.connect()

    def test_injected_fake_client(self, ftp):
        fs = ftp.SFTPFileSystem(client=FakeSFTP())
        fs.connect()
        fs.create("w.bin", b"123")
        assert fs.read("w.bin") == b"123"
        fs.rename("w.bin", "w2.bin")
        assert [i.name for i in fs.read_dir()] == ["w2.bin"]
        fs.remove("w2.bin")
        assert fs.health_check()["status"] == "UP"


# ------------------------------------------------------------- NATS-KV
class _JetStream:
    """A Mini JetStream server of one side on a loop thread of its own."""

    def __init__(self, side: str) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.srv = side_module(side, "jetstream").MiniJetStreamServer()
        self._call(self.srv.start())
        self.port = self.srv.port
        self.streams = self.srv.streams

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(10)

    def close(self) -> None:
        self._call(self.srv.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)
        self.loop.close()


class TestNATSKV:
    """Every case of ``tests/test_nats_kv.py``."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def pair(self, request):
        client, server_side = request.param
        js = _JetStream(server_side)
        yield side_module(client, "nats_kv"), client, js
        js.close()

    @pytest.fixture()
    def kv(self, pair):
        mod, _, server = pair
        store = mod.NATSKV(port=server.port, bucket="app")
        store.connect()
        yield store
        store.close()

    def test_set_get_roundtrip(self, kv):
        kv.set("greeting", "hello")
        assert kv.get("greeting") == "hello"
        kv.set("greeting", "hello again")
        assert kv.get("greeting") == "hello again"

    def test_missing_key(self, pair, kv):
        with pytest.raises(pair[0].KeyNotFound):
            kv.get("never-written")

    def test_delete_writes_tombstone(self, pair, kv):
        server = pair[2]
        kv.set("doomed", "v")
        assert kv.get("doomed") == "v"
        kv.delete("doomed")
        with pytest.raises(pair[0].KeyNotFound):
            kv.get("doomed")
        subject, payload, hdrs = server.streams["KV_app"].messages[-1]
        assert subject == "$KV.app.doomed"
        assert payload == b""
        assert b"KV-Operation: DEL" in hdrs
        kv.set("doomed", "reborn")
        assert kv.get("doomed") == "reborn"

    def test_dotted_keys_are_distinct(self, kv):
        kv.set("cfg.db.host", "a")
        kv.set("cfg.db.port", "b")
        assert kv.get("cfg.db.host") == "a"
        assert kv.get("cfg.db.port") == "b"

    def test_invalid_names_rejected(self, pair):
        mod, _, server = pair
        with pytest.raises(mod.KVError):
            mod.NATSKV(port=server.port, bucket="has.dot")
        store = mod.NATSKV(port=server.port, bucket="ok")
        store.connect()
        try:
            for bad in ("", "a b", "star*", ".leading", "trailing."):
                with pytest.raises(mod.KVError):
                    store.set(bad, "x")
        finally:
            store.close()

    def test_buckets_are_isolated(self, pair):
        mod, _, server = pair
        a = mod.NATSKV(port=server.port, bucket="tenant_a")
        b = mod.NATSKV(port=server.port, bucket="tenant_b")
        a.connect()
        b.connect()
        try:
            a.set("k", "from-a")
            b.set("k", "from-b")
            assert a.get("k") == "from-a"
            assert b.get("k") == "from-b"
        finally:
            a.close()
            b.close()

    def test_health_and_container_wiring(self, pair):
        mod, client, server = pair
        pkg = "gofr_tpu_torch" if client == "port" else "gofr_tpu"
        env = __import__(f"{pkg}.config.env", fromlist=["DictConfig"])
        cont = __import__(f"{pkg}.container.container",
                          fromlist=["Container"])
        container = cont.Container(env.DictConfig({"APP_NAME": "kvtest"}))
        container.register_framework_metrics()
        store = container.add_kv_store(
            mod.NATSKV(port=server.port, bucket="health"))
        store.connect()
        try:
            store.set("k", "v")
            assert store.get("k") == "v"
            assert store.health_check()["status"] == "UP"
            assert container.kv is store
            # the histogram the container registers gets its samples
            assert container.metrics.get_histogram_count(
                "app_nats_kv_stats", type="set") == 1
            assert container.metrics.get_histogram_count(
                "app_nats_kv_stats", type="get") == 1
        finally:
            store.close()
        assert store.health_check()["status"] == "DOWN"


# ---------------------------------------------------------------- SFTP
class TestSFTPWire:
    """Every case of ``tests/test_sftp_wire.py``."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("sftp", request.param)

    @pytest.fixture(scope="class")
    def server(self, m, tmp_path_factory):
        root = tmp_path_factory.mktemp("sftp_root")
        srv = m.MiniSFTPServer(root, users={"app": "s3cr3t"})
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def fs(self, m, server):
        client = m.SFTPWire(host="127.0.0.1", port=server.port,
                            username="app", password="s3cr3t",
                            expected_host_key=server.host_public_key())
        client.connect()
        yield client
        client.close()

    def test_create_read_roundtrip(self, fs):
        fs.create("hello.txt", "hello over ssh\n")
        assert fs.read_text("hello.txt") == "hello over ssh\n"
        payload = bytes(range(256)) * 512
        fs.create("blob.bin", payload)
        assert fs.read("blob.bin") == payload

    def test_append_stat_exists(self, fs):
        fs.create("log.txt", "one\n")
        fs.append("log.txt", "two\n")
        assert fs.read_text("log.txt") == "one\ntwo\n"
        info = fs.stat("log.txt")
        assert info.size == 8 and not info.is_dir and info.mod_time > 0
        assert fs.exists("log.txt") is True
        assert fs.exists("nope.txt") is False

    def test_mkdir_readdir_rename_remove(self, fs):
        fs.mkdir("data")
        fs.create("data/a.csv", "x,y\n1,2\n")
        fs.create("data/b.csv", "x,y\n3,4\n")
        assert [f.name for f in fs.read_dir("data")] == ["a.csv", "b.csv"]
        root_entries = {f.name: f for f in fs.read_dir("/")}
        assert root_entries["data"].is_dir
        fs.rename("data/a.csv", "data/renamed.csv")
        assert fs.exists("data/renamed.csv") and not fs.exists("data/a.csv")
        assert list(fs.read_rows("data/renamed.csv")) == [
            {"x": "1", "y": "2"}]
        fs.remove("data/renamed.csv")
        fs.remove("data/b.csv")
        fs.rmdir("data")
        assert not fs.exists("data")

    def test_missing_file_errors(self, m, fs):
        with pytest.raises(m.SFTPError, match="no such file"):
            fs.read("missing.bin")
        with pytest.raises(m.SFTPError):
            fs.remove("missing.bin")
        with pytest.raises(m.SFTPError):
            fs.stat("missing.bin")

    def test_path_jail(self, fs, server):
        fs.create("../escape.txt", "jailed")
        assert (server.root / "escape.txt").exists()
        assert not (server.root.parent / "escape.txt").exists()
        fs.remove("escape.txt")

    def test_wrong_password_rejected(self, m, server):
        bad = m.SFTPWire(host="127.0.0.1", port=server.port,
                         username="app", password="WRONG",
                         insecure_skip_host_key=True)
        with pytest.raises(m.SSHAuthError):
            bad.connect()

    def test_host_key_pinning_detects_mitm(self, m, server):
        pinned = m.SFTPWire(host="127.0.0.1", port=server.port,
                            username="app", password="s3cr3t",
                            expected_host_key=b"\x00" * 32)
        with pytest.raises(m.SSHError, match="host key mismatch"):
            pinned.connect()

    def test_no_host_key_policy_refused(self, m, server):
        lax = m.SFTPWire(host="127.0.0.1", port=server.port,
                         username="app", password="s3cr3t")
        with pytest.raises(m.SSHError, match="host key policy"):
            lax.connect()

    def test_paramiko_style_aliases(self, fs):
        fs.putfo(io.BytesIO(b"injected"), "via_putfo.bin")
        buf = io.BytesIO()
        fs.getfo("via_putfo.bin", buf)
        assert buf.getvalue() == b"injected"
        assert "via_putfo.bin" in fs.listdir("/")
        fs.remove("via_putfo.bin")

    def test_injected_into_existing_sftp_filesystem(self, m, server):
        ftp = side_module(m.client, "ftp")
        wire = m.SFTPWire(host="127.0.0.1", port=server.port,
                          username="app", password="s3cr3t",
                          insecure_skip_host_key=True)
        wire.connect()
        fs = ftp.SFTPFileSystem(client=wire)
        fs.connect()
        fs.create("nested.txt", "through the adapter")
        assert fs.read("nested.txt") == b"through the adapter"
        assert "nested.txt" in [f.name for f in fs.read_dir("/")]
        fs.remove("nested.txt")
        wire.close()

    def test_health(self, m, fs):
        assert fs.health_check()["status"] == "UP"
        assert m.SFTPWire(host="127.0.0.1", port=1).health_check()[
            "status"] == "DOWN"


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_sftp_over_ssh_survives_byte_dribble(pair, tmp_path):
    """``tests/test_wire_fragmentation.py``'s SFTP case: the whole SSH2
    stack over one-byte fragments, both ways."""
    from .test_wire_fragmentation import DribbleProxy
    m = Pair("sftp", pair)
    srv = m.MiniSFTPServer(tmp_path / "root", users={"u": "p"})
    srv.start()
    proxy = DribbleProxy("127.0.0.1", srv.port)
    try:
        fs = m.SFTPWire(host="127.0.0.1", port=proxy.port,
                        username="u", password="p",
                        expected_host_key=srv.host_public_key())
        fs.connect()
        fs.create("frag.bin", b"\x01\x02" * 256)
        assert fs.read("frag.bin") == b"\x01\x02" * 256
        fs.close()
    finally:
        proxy.close()
        srv.close()


# ------------------------------------------------------ cross sessions
def _outcome(fn):
    """(``ok``, value) or the error's (type name, message)."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))


def _ftp_session(pair):
    m = Pair("ftp", pair)
    srv = m.MiniFTPServer()
    srv.start()
    fs = m.FTPFileSystem(port=srv.port, user="u", password="p")
    fs.connect()
    try:
        steps = [
            _outcome(lambda: fs.create("a.txt", "alpha")),
            _outcome(lambda: fs.create("b.bin", bytes(range(256)) * 40)),
            _outcome(lambda: fs.append("a.txt", b"+beta")),
            _outcome(lambda: fs.read("a.txt")),
            _outcome(lambda: len(fs.read("b.bin"))),
            _outcome(lambda: fs.mkdir("dir")),
            _outcome(lambda: fs.create("dir/c.csv", "k,v\n1,2\n3,4\n")),
            _outcome(lambda: list(fs.read_rows("dir/c.csv"))),
            _outcome(lambda: sorted(i.name for i in fs.read_dir())),
            _outcome(lambda: (fs.stat("a.txt").name, fs.stat("a.txt").size,
                              fs.stat("a.txt").is_dir)),
            _outcome(lambda: fs.exists("nope.txt")),
            _outcome(lambda: fs.read("nope.txt")),
            _outcome(lambda: fs.rename("a.txt", "z.txt")),
            _outcome(lambda: fs.remove("b.bin")),
            _outcome(lambda: fs.remove("b.bin")),
            _outcome(lambda: sorted(i.name for i in fs.read_dir())),
            _outcome(lambda: fs.health_check()["status"]),
        ]
        return steps, dict(srv._files)
    finally:
        fs.close()
        srv.close()


def _nats_kv_session(pair):
    client, server_side = pair
    js = _JetStream(server_side)
    mod = side_module(client, "nats_kv")
    kv = mod.NATSKV(port=js.port, bucket="s")
    kv.connect()
    try:
        steps = [
            _outcome(lambda: kv.set("a", "1")),
            _outcome(lambda: kv.set("a.b", "2")),
            _outcome(lambda: kv.set("a", "3")),
            _outcome(lambda: kv.get("a")),
            _outcome(lambda: kv.get("a.b")),
            _outcome(lambda: kv.get("zz")),
            _outcome(lambda: kv.delete("a")),
            _outcome(lambda: kv.get("a")),
            _outcome(lambda: kv.set("bad key", "x")),
            _outcome(lambda: kv.set("u", "ünï\x00code")),
            _outcome(lambda: kv.get("u")),
            _outcome(lambda: kv.health_check()["status"]),
        ]
        stream = [(s, p, b"KV-Operation: DEL" in (h or b""))
                  for s, p, h in js.streams["KV_s"].messages]
        return steps, stream
    finally:
        kv.close()
        js.close()


def _sftp_session(pair, root):
    m = Pair("sftp", pair)
    srv = m.MiniSFTPServer(root, users={"app": "pw"})
    srv.start()
    fs = m.SFTPWire(host="127.0.0.1", port=srv.port, username="app",
                    password="pw", expected_host_key=srv.host_public_key())
    fs.connect()
    try:
        steps = [
            _outcome(lambda: fs.mkdir("d")),
            _outcome(lambda: fs.create("d/x.txt", "x" * 70000)),
            _outcome(lambda: fs.append("d/x.txt", "tail")),
            _outcome(lambda: len(fs.read("d/x.txt"))),
            _outcome(lambda: fs.create("y.csv", "a,b\n1,2\n")),
            _outcome(lambda: list(fs.read_rows("y.csv"))),
            _outcome(lambda: sorted((f.name, f.is_dir, f.size)
                                    for f in fs.read_dir("/"))),
            _outcome(lambda: fs.stat("d/x.txt").size),
            _outcome(lambda: fs.read("nope")),
            _outcome(lambda: fs.rmdir("d")),
            _outcome(lambda: fs.rename("y.csv", "d/y.csv")),
            _outcome(lambda: sorted(fs.listdir("d"))),
            _outcome(lambda: fs.exists("y.csv")),
            _outcome(lambda: fs.remove("d/y.csv")),
            _outcome(lambda: fs.health_check()["status"]),
        ]
        files = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        # the server's errors name its root directory
        steps = [(kind, value.replace(str(root), "<root>"))
                 if isinstance(value, str) else (kind, value)
                 for kind, value in steps]
        return steps, files
    finally:
        fs.close()
        srv.close()


@pytest.mark.parametrize("direction", CROSS, ids=CROSS_IDS)
def test_ftp_cross_session_matches_jax(direction):
    assert _ftp_session(direction) == _ftp_session(("jax", "jax"))


@pytest.mark.parametrize("direction", CROSS, ids=CROSS_IDS)
def test_nats_kv_cross_session_matches_jax(direction):
    assert _nats_kv_session(direction) == _nats_kv_session(("jax", "jax"))


@pytest.mark.parametrize("direction", CROSS, ids=CROSS_IDS)
def test_sftp_cross_session_matches_jax(direction, tmp_path):
    assert _sftp_session(direction, tmp_path / "a") == \
        _sftp_session(("jax", "jax"), tmp_path / "b")


@pytest.mark.parametrize("store", ["ftp", "sftp"])
def test_file_stores_record_their_stats(store, tmp_path):
    """``Instrumented`` stores write their ``app_<store>_stats`` samples
    into the container's registry on the port as on JAX."""
    counts = {}
    for side in ("port", "jax"):
        pkg = "gofr_tpu_torch" if side == "port" else "gofr_tpu"
        cont = __import__(f"{pkg}.container.container",
                          fromlist=["Container"])
        c = cont.Container()
        c.register_framework_metrics()
        if store == "ftp":
            mod = side_module(side, "ftp")
            srv = mod.MiniFTPServer()
            srv.start()
            fs = c.add_file_store(mod.FTPFileSystem(port=srv.port))
        else:
            mod = side_module(side, "sftp")
            srv = mod.MiniSFTPServer(tmp_path / side, users={"u": "p"})
            srv.start()
            fs = c.add_file_store(mod.SFTPWire(
                host="127.0.0.1", port=srv.port, username="u",
                password="p", expected_host_key=srv.host_public_key()))
        fs.connect()
        try:
            fs.create("f.txt", "v")
            fs.read("f.txt")
            rendered = c.metrics.render_prometheus()
            counts[side] = sorted(
                line.split(" ")[0] for line in rendered.splitlines()
                if line.startswith("app_") and "_stats_count" in line)
            assert counts[side], rendered
        finally:
            fs.close()
            srv.close()
    assert counts["port"] == counts["jax"]


def test_mini_ftp_server_answers_without_a_delayed_ack_stall():
    """A transfer's replies ("150", then "226" after the data connection)
    leave the port's Mini FTP server at once: it sets TCP_NODELAY, so
    Nagle does not hold the second reply until the client's delayed ACK
    (~40 ms on Linux; JAX's Mini FTP server answers each transfer that
    late on loopback, ROADMAP Queue C, C12). The median of 21 writes and
    of 21 reads stays under 10 ms."""
    import statistics
    import time

    m = Pair("ftp", ("port", "port"))
    srv = m.MiniFTPServer()
    srv.start()
    fs = m.FTPFileSystem(port=srv.port)
    fs.connect()
    try:
        writes, reads = [], []
        for i in range(21):
            t0 = time.perf_counter()
            fs.create(f"f{i}.txt", "x" * 64)
            writes.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            assert fs.read(f"f{i}.txt") == b"x" * 64
            reads.append(time.perf_counter() - t0)
    finally:
        fs.close()
        srv.close()
    assert statistics.median(writes) < 0.010
    assert statistics.median(reads) < 0.010
