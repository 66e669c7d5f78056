"""The apps of ``examples_torch/`` on the PyTorch port: each boots for
real and answers its ``examples/`` twin's case of
``tests/test_examples.py`` over localhost, with the same requests and
assertions (the model apps on the CPU, asked for by ``device="cpu"``).

Beside them:

- the two trees hold the same apps, and each port app's source equals
  its JAX twin's after the ``gofr_tpu`` -> ``gofr_tpu_torch`` rename but
  for the lines :data:`PORT_LINES` lists, each with its reason;
- ``grpc-protogen/order_gofr.py`` is what the port's generator writes;
- booted from one JAX-written checkpoint, ``model-serving`` and
  ``asr-worker`` give the JAX examples' greedy tokens (and Llama's
  ``request_digest``);
- the operator tools over the port: ``scripts/torch_capacity.py``
  (JAX's two cases of ``tests/test_goodput.py``, and its setpoint file
  read by the port's router), ``scripts/torch_replay.py`` (exit 0, and
  2 on a changed token) and ``scripts/bundle.py`` against a port app
  (the surfaces it collects from a JAX app);
- an ``async def`` handler awaiting the port's service client, as JAX's
  ``using-http-service`` does, answers while the loop stays live.
"""

from __future__ import annotations

import asyncio
import difflib
import importlib.util
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from gofr_tpu_torch.config import DictConfig

from .torch_apputil import AppRunner, grpc_channel

ROOT = Path(__file__).parent.parent
EXAMPLES = ROOT / "examples_torch"
JAX_EXAMPLES = ROOT / "examples"
GLUE = "order_gofr"


def load_example(name: str):
    """Import examples_torch/<name>/main.py as ``torch_example_<name>``
    (``tests/test_examples.py`` loads JAX's as ``example_<name>``). The
    protogen app imports its glue as ``order_gofr`` from its own
    directory: JAX's glue of that name is set aside meanwhile, the
    port's is kept as ``torch_example_order_gofr``, and ``sys.path`` is
    restored."""
    path = EXAMPLES / name / "main.py"
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    saved_path = list(sys.path)
    saved_glue = sys.modules.pop(GLUE, None)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        glue = sys.modules.pop(GLUE, None)
        if glue is not None:
            sys.modules[f"torch_example_{GLUE}"] = glue
        if saved_glue is not None:
            sys.modules[GLUE] = saved_glue
        sys.path[:] = saved_path
    return module


def cfg(**kw) -> DictConfig:
    return DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                       "APP_NAME": "example", **kw})


# ------------------------------------------------------ the two trees
def _apps(root: Path) -> set:
    return {p.name for p in root.iterdir() if p.is_dir()
            and p.name != "__pycache__"}


def test_every_jax_example_has_a_port_counterpart():
    assert _apps(EXAMPLES) == _apps(JAX_EXAMPLES)
    assert len(_apps(EXAMPLES)) == 21
    for app in _apps(JAX_EXAMPLES):
        jax_files = {p.name for p in (JAX_EXAMPLES / app).iterdir()
                     if p.is_file()}
        port_files = {p.name for p in (EXAMPLES / app).iterdir()
                      if p.is_file()}
        assert port_files == jax_files, app


#: Every line where a port app differs from its JAX twin after the
#: rename: (app, JAX lines, port lines, reason). A hunk not listed here,
#: or listed and gone, fails the parity test.
MODULE_PATH = ("module path: JAX's service/ package is the port's "
               "service.py")
DEVICE = ("generator and device: the port's initialisers take a "
          "torch.Generator and a device, and the app runs on CUDA unless "
          "the caller asks for the CPU (build_app(device=))")
DIST = ("the data plane's hand-off: torch.distributed's "
        "init_process_group(**dist_init_args()) where JAX calls "
        "jax.distributed.initialize(**jax_initialize_args())")
TREE = "the port's tree: examples_torch/"
VOCAB = ("a repaired fault (C18): the tiny preset's 256-id vocabulary "
         "cannot hold the byte tokenizer's ids (BOS 257); JAX's gather "
         "clamps them to 255, the port's engine refuses them at submit")
PORT_LINES = [
    ("using-http-service",
     ["from gofr_tpu_torch.service.client import CircuitBreaker, Retry, "
      "new_http_service"],
     ["from gofr_tpu_torch.service import CircuitBreaker, Retry, "
      "new_http_service"], MODULE_PATH),
    ("grpc-protogen",
     ["python -m gofr_tpu_torch.grpc.protogen "
      "examples/grpc-protogen/order.proto"],
     ["python -m gofr_tpu_torch.grpc.protogen "
      "examples_torch/grpc-protogen/order.proto"], TREE),
    ("multi-host-serving",
     ["On a real pod each worker's ``on_assignment`` callback calls",
      "``jax.distributed.initialize(**assignment.jax_initialize_args())`` "
      "and",
      "relaunches the mesh-sharded engine; here it prints the assignment."],
     ["On a real cluster each worker's ``on_assignment`` callback calls",
      "``torch.distributed.init_process_group(**assignment."
      "dist_init_args())``",
      "and relaunches the mesh-sharded engine; here it prints the "
      "assignment."], DIST),
    ("multi-host-serving",
     ['f"-> jax.distributed.initialize("',
      'f"{assignment.jax_initialize_args()})")'],
     ['f"-> torch.distributed.init_process_group("',
      'f"{assignment.dist_init_args()})")'], DIST),
    ("model-serving",
     ["def build_app(config=None) -> App:", "import jax"],
     ["def build_app(config=None, *, device=None) -> App:", "import torch",
      "from gofr_tpu_torch.device import resolve_device"], DEVICE),
    ("model-serving",
     ["dtype=resolve_serving_dtype(dtype_name) if dtype_name else None)"],
     ["dtype=resolve_serving_dtype(dtype_name) if dtype_name else None,",
      "device=device)"], DEVICE),
    ("model-serving",
     ["params = llama_init(jax.random.key(0), model_config)"],
     ["# the byte tokenizer's ids (BOS 257, EOS 258) must lie inside the",
      "# model's vocabulary, which the tiny preset's 256 does not hold",
      "model_config = model_config.scaled(",
      "vocab_size=max(model_config.vocab_size, tokenizer.vocab_size))",
      "params = llama_init(model_config, torch.Generator().manual_seed(0),",
      "resolve_device(device))"], f"{VOCAB}; {DEVICE}"),
    ("model-serving",
     ["quantize=quant)"], ["device=device, quantize=quant)"], DEVICE),
    ("asr-worker",
     ["def build_app(config=None) -> App:", "import jax"],
     ["def build_app(config=None, *, device=None) -> App:", "import torch",
      "from gofr_tpu_torch.device import resolve_device"], DEVICE),
    ("asr-worker",
     ["dtype=resolve_serving_dtype(dtype_name) if dtype_name else None)"],
     ["dtype=resolve_serving_dtype(dtype_name) if dtype_name else None,",
      "device=device)"], DEVICE),
    ("asr-worker",
     ["params = whisper_init(jax.random.key(0), model_config)"],
     ["params = whisper_init(model_config, "
      "torch.Generator().manual_seed(0),",
      "resolve_device(device))"], DEVICE),
    ("asr-worker",
     ["sample_buckets=(16000, 80000)))"],
     ["sample_buckets=(16000, 80000)),", "device=device)"], DEVICE),
]


def _renamed(text: str) -> str:
    return re.sub(r"\bgofr_tpu\b", "gofr_tpu_torch", text)


def _hunks(jax_text: str, port_text: str) -> list:
    a = [line.strip() for line in _renamed(jax_text).splitlines()]
    b = [line.strip() for line in port_text.splitlines()]
    matcher = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    return [(a[i1:i2], b[j1:j2])
            for op, i1, i2, j1, j2 in matcher.get_opcodes() if op != "equal"]


@pytest.mark.parametrize("app", sorted(_apps(JAX_EXAMPLES)))
def test_port_app_text_equals_its_jax_twin(app):
    listed = [(jax, port) for name, jax, port, reason in PORT_LINES
              if name == app]
    assert all(reason for *_, reason in PORT_LINES)
    found = []
    for path in sorted((JAX_EXAMPLES / app).glob("*.py")):
        found += _hunks(path.read_text(),
                        (EXAMPLES / app / path.name).read_text())
    assert found == listed


def test_protogen_glue_is_the_generators_output():
    from gofr_tpu_torch.grpc.protogen import generate
    want = generate(EXAMPLES / "grpc-protogen" / "order.proto")
    got = (EXAMPLES / "grpc-protogen" / "order_gofr.py").read_text()
    if "FILE_DESCRIPTOR_SET" not in want:   # no protoc: no descriptors
        got = got[:got.index("\n\n#: protoc-compiled")] + "\n"
    assert got == want
    assert "from gofr_tpu_torch.grpc.service import" in got


# ------------------------------------- tests/test_examples.py, mirrored
def test_http_server():
    mod = load_example("http-server")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        status, body = runner.get_json("/greet?name=tpu")
        assert (status, body["data"]) == (200, "Hello tpu!")
        status, body = runner.get_json("/users/1")
        assert body["data"]["name"] == "ada"
        status, _, data = runner.request("POST", "/users",
                                         {"name": "alan"})
        assert status == 201
        status, body = runner.get_json("/users/99")
        assert status == 404 and "error" in body


def test_http_server_using_redis():
    mod = load_example("http-server-using-redis")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        for _ in range(3):
            runner.request("POST", "/visit/home")
        status, body = runner.get_json("/visit/home")
        assert body["data"]["visits"] == 3


def test_sample_cmd(capsys):
    mod = load_example("sample-cmd")
    app = mod.build_app()
    assert app.run(["greet", "--name=tpu"]) == 0
    assert "hello tpu" in capsys.readouterr().out
    assert app.run(["greet", "--name=tpu", "--shout"]) == 0
    assert "HELLO TPU" in capsys.readouterr().out
    assert app.run(["version"]) == 0
    assert app.run(["nope"]) == 2  # unknown -> help + exit 2


def test_using_add_filestore():
    mod = load_example("using-add-filestore")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        runner.request("POST", "/notes/ideas", {"text": "pallas kernels"})
        status, body = runner.get_json("/notes/ideas")
        assert body["data"]["text"] == "pallas kernels"
        status, body = runner.get_json("/notes")
        assert "ideas.txt" in body["data"]


def test_using_add_rest_handlers():
    mod = load_example("using-add-rest-handlers")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        status, _, _ = runner.request(
            "POST", "/book", {"id": 1, "title": "scaling", "author": "jax"})
        assert status == 201
        status, body = runner.get_json("/book/1")
        assert body["data"]["title"] == "scaling"
        status, _, _ = runner.request("PUT", "/book/1",
                                      {"title": "scaling v2", "author": "jax"})
        assert status == 200
        status, body = runner.get_json("/book")
        assert len(body["data"]) == 1
        status, _, _ = runner.request("DELETE", "/book/1")
        assert status == 204


def test_using_cron_jobs():
    mod = load_example("using-cron-jobs")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        status, body = runner.get_json("/runs")
        assert status == 200
        assert "runs" in body["data"]  # job registered; fires on minute tick


def test_using_custom_metrics():
    mod = load_example("using-custom-metrics")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        runner.request("POST", "/order", {"amount": 42})
        status, _, data = runner.request("GET", "/metrics",
                                         port=runner.metrics_port)
        scrape = data.decode()
        assert "orders_created" in scrape
        assert "order_amount" in scrape
        assert "inventory_level" in scrape


def test_using_file_bind():
    mod = load_example("using-file-bind")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        boundary = "xyzBOUNDARY"
        body = (f"--{boundary}\r\n"
                'Content-Disposition: form-data; name="title"\r\n\r\n'
                "report\r\n"
                f"--{boundary}\r\n"
                'Content-Disposition: form-data; name="doc"; '
                'filename="r.txt"\r\n'
                "Content-Type: text/plain\r\n\r\n"
                "hello bytes\r\n"
                f"--{boundary}--\r\n")
        status, _, data = runner.request(
            "POST", "/upload", body,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        assert status == 201
        out = json.loads(data)["data"]
        assert out["title"] == "report"
        assert out["doc"] == {"filename": "r.txt", "bytes": 11}


def test_using_html_template(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # templates materialize under tmp
    mod = load_example("using-html-template")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        status, _, data = runner.request("GET", "/hello?name=tpu")
        assert status == 200
        assert b"<h1>Hello tpu</h1>" in data


def test_using_http_auth_middleware():
    import base64
    mod = load_example("using-http-auth-middleware")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        status, _, _ = runner.request("GET", "/secret")
        assert status == 401
        creds = base64.b64encode(b"ada:lovelace").decode()
        status, _, data = runner.request(
            "GET", "/secret", headers={"Authorization": f"Basic {creds}"})
        assert status == 200
        # health stays open without credentials
        status, _, _ = runner.request("GET", "/.well-known/alive")
        assert status == 200


def test_using_http_service():
    mod = load_example("using-http-service")
    # a real downstream app
    from gofr_tpu_torch.app import App
    downstream = App(config=cfg())

    @downstream.get("/items/{id}")
    def item(ctx):
        return {"id": ctx.path_param("id"), "price": 9.5}

    with AppRunner(app=downstream) as down:
        app = mod.build_app(cfg(),
                            downstream_url=f"http://127.0.0.1:{down.port}")
        with AppRunner(app=app) as runner:
            status, body = runner.get_json("/proxy/tpu")
            assert status == 200
            assert body["data"]["data"]["id"] == "tpu"


def test_using_migrations():
    mod = load_example("using-migrations")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        status, body = runner.get_json("/employees")
        assert [r["name"] for r in body["data"]] == ["ada", "grace"]
        # ledger recorded both versions
        rows = runner.app.container.sql.query(
            "SELECT version FROM gofr_migrations ORDER BY version")
        assert len(rows) == 2


def test_publisher_and_subscriber_pair():
    # apps run in separate event loops, so share a real broker over TCP
    # (the in-memory broker's queues are loop-bound)
    ready = threading.Event()
    holder = {}

    def run_broker():
        async def main():
            from gofr_tpu_torch.pubsub.nats import MiniNATSServer
            server = MiniNATSServer()
            await server.start()
            holder["port"] = server.port
            ready.set()
            await asyncio.Event().wait()
        asyncio.run(main())

    threading.Thread(target=run_broker, daemon=True).start()
    assert ready.wait(5)
    nats_cfg = {"PUBSUB_BACKEND": "NATS",
                "PUBSUB_BROKER": f"127.0.0.1:{holder['port']}"}

    pub_mod = load_example("using-publisher")
    sub_mod = load_example("using-subscriber")
    sub_app = sub_mod.build_app(cfg(**nats_cfg))
    pub_app = pub_mod.build_app(cfg(**nats_cfg))
    sub_mod.SEEN.clear()
    with AppRunner(app=sub_app):
        with AppRunner(app=pub_app) as pub:
            status, _, _ = pub.request("POST", "/publish/order",
                                       {"id": 7, "item": "tpu"})
            assert status == 201
            deadline = time.time() + 5
            while not sub_mod.SEEN and time.time() < deadline:
                time.sleep(0.02)
            assert sub_mod.SEEN == [{"id": 7, "item": "tpu"}]


def test_using_web_socket():
    mod = load_example("using-web-socket")
    with AppRunner(app=mod.build_app(cfg())) as runner:
        from gofr_tpu_torch.websocket import connect

        async def flow():
            conn = await connect(f"ws://127.0.0.1:{runner.port}/ws/echo")
            await conn.send("ping")
            reply = await conn.recv()
            await conn.close()
            return reply.text()
        reply = asyncio.run(flow())
        assert json.loads(reply) == {"echo": "ping"}


def test_grpc_server():
    mod = load_example("grpc-server")
    app = mod.build_app(cfg(GRPC_PORT="0"))
    with AppRunner(app=app):
        from gofr_tpu_torch.grpc import GRPCClient

        async def flow():
            client = GRPCClient(f"127.0.0.1:{app.grpc_server.bound_port}")
            reply = await client.call("examples.Greeter", "SayHello",
                                      {"name": "tpu"})
            ticks = []
            async for item in client.stream(
                    "examples.Greeter", "Countdown", {"from": 2}):
                ticks.append(item["t_minus"])
            await client.close()
            return reply, ticks
        reply, ticks = asyncio.run(flow())
        assert reply["message"] == "Hello tpu!"
        assert ticks == [2, 1]


def test_grpc_protogen_example():
    """The protogen example: .proto → generated skeleton → served app,
    called through the generated client (the port's glue, loaded under
    its own module name)."""
    mod = load_example("grpc-protogen")
    order_gofr = mod.order_gofr
    assert order_gofr is sys.modules[f"torch_example_{GLUE}"]
    assert Path(order_gofr.__file__).parent == EXAMPLES / "grpc-protogen"
    app = mod.build_app(cfg(GRPC_PORT="0"))
    with AppRunner(app=app):
        async def flow():
            async with grpc_channel(
                    app.grpc_server.bound_port) as channel:
                client = order_gofr.OrderDeskClient(channel)
                ack = await client.Place(order_gofr.Order(
                    id="o-7", item="tpu", quantity=2))
                ack = ack.get("data", ack)
                statuses = []
                async for item in client.Track(
                        order_gofr.Order(id="o-7")):
                    statuses.append(item.get("data", item)["status"])
                return ack, statuses
        ack, statuses = asyncio.run(flow())
        assert ack["status"] == "ACCEPTED"
        assert statuses == ["ACCEPTED", "PACKED", "SHIPPED"]


def test_grpc_client_example():
    """The client example drives the server example end-to-end: HTTP
    in, gRPC out (unary + stream + health)."""
    server_mod = load_example("grpc-server")
    server_app = server_mod.build_app(cfg(GRPC_PORT="0"))
    with AppRunner(app=server_app):
        target = f"127.0.0.1:{server_app.grpc_server.bound_port}"
        client_mod = load_example("grpc-client")
        client_app = client_mod.build_app(cfg(), grpc_target=target)
        with AppRunner(app=client_app) as front:
            status, body = front.get_json("/hello?name=mesh")
            assert status == 200
            assert body["data"]["message"] == "Hello mesh!"
            status, body = front.get_json("/countdown?from=2")
            assert [m["t_minus"] for m in body["data"]["messages"]] \
                == [2, 1]
            status, body = front.get_json("/downstream-health")
            assert body["data"]["status"] == "SERVING"


def test_multi_host_serving_example(capsys):
    from gofr_tpu_torch.logging.logger import (clear_fleet_context,
                                               current_fleet_context,
                                               set_fleet_context)
    mod = load_example("multi-host-serving")
    app = mod.build_app(cfg())
    # a join sets the process-wide fleet context (every later span and
    # log line names the host): put back what this worker process had
    saved = current_fleet_context()
    try:
        with AppRunner(app=app) as runner:
            w1 = mod.run_worker(f"http://127.0.0.1:{runner.port}", "h1")
            w2 = mod.run_worker(f"http://127.0.0.1:{runner.port}", "h2")
            try:
                status, body = runner.get_json("/control/topology")
                assert status == 200
                assert body["data"]["world_size"] == 2
                assert w1.assignment.rank == 0
                assert w2.assignment.rank == 1
            finally:
                w1.stop()
                w2.stop()
    finally:
        clear_fleet_context()
        set_fleet_context(**saved)
    printed = capsys.readouterr().out
    assert "init_process_group({'init_method': 'tcp://" in printed


def test_model_serving():
    mod = load_example("model-serving")
    with AppRunner(app=mod.build_app(cfg(), device="cpu")) as runner:
        status, _, data = runner.request(
            "POST", "/chat",
            {"prompt": "hi", "max_new_tokens": 4, "temperature": 0.0})
        assert status in (200, 201)
        out = json.loads(data)["data"]
        assert "text" in out or "tokens" in out
        # engine visible in health
        status, body = runner.get_json("/.well-known/health")
        assert "tpu" in body["data"]["checks"]


def _jax_llama_checkpoint(path: Path, seed: int = 3) -> None:
    """JAX's tiny Llama checkpoint with JAX's test tokenizer
    (``_mini_tokenizer_json``: ids up to 301), at a vocabulary of 320
    that holds them: JAX's own case writes 256, whose gather clamps the
    ids past it, where the port's engine refuses such a prompt."""
    import jax

    from gofr_tpu.models.hf_checkpoint import save_llama_checkpoint
    from gofr_tpu.models.llama import LlamaConfig, llama_init

    from .test_hf_checkpoint import _mini_tokenizer_json
    cfg_t = LlamaConfig.tiny().scaled(vocab_size=320)
    save_llama_checkpoint(llama_init(jax.random.key(seed), cfg_t), cfg_t,
                          path)
    _mini_tokenizer_json(path)


def test_model_serving_from_disk_checkpoint(tmp_path):
    """MODEL_PATH: the example boots from an on-disk HF-format
    checkpoint (weights + tokenizer.json) and serves /chat and /v1
    with the loaded weights."""
    _jax_llama_checkpoint(tmp_path)
    mod = load_example("model-serving")
    app = mod.build_app(cfg(MODEL_PATH=str(tmp_path),
                            MODEL_MAX_SEQ="128"), device="cpu")
    with AppRunner(app=app) as runner:
        status, _, data = runner.request(
            "POST", "/chat",
            {"prompt": "the cat", "max_new_tokens": 4,
             "temperature": 0.0})
        assert status in (200, 201)
        out = json.loads(data)["data"]
        assert "text" in out or "tokens" in out
        # the OpenAI surface runs the HF tokenizer loaded from disk
        status, _, data = runner.request(
            "POST", "/v1/completions",
            {"model": tmp_path.name, "prompt": "the cat",
             "max_tokens": 4, "temperature": 0.0})
        assert status in (200, 201)
        body = json.loads(data)
        assert body["model"] == tmp_path.name
        assert body["choices"][0]["text"] is not None


def test_asr_worker():
    mod = load_example("asr-worker")
    app = mod.build_app(cfg(), device="cpu")
    with AppRunner(app=app) as runner:
        tone = np.sin(np.linspace(0, 440, 4000)).astype(np.float32)
        status, _, data = runner.request("POST", "/transcribe",
                                         {"audio": tone.tolist()})
        assert status == 201
        assert "tokens" in json.loads(data)["data"]


def _jax_whisper_checkpoint(path: Path, seed: int = 2) -> None:
    import jax

    from gofr_tpu.models.hf_checkpoint import save_whisper_checkpoint
    from gofr_tpu.models.whisper import WhisperConfig, whisper_init
    cfg_w = WhisperConfig.tiny_test()
    save_whisper_checkpoint(whisper_init(jax.random.key(seed), cfg_w),
                            cfg_w, path)


def test_asr_worker_from_disk_checkpoint(tmp_path):
    """MODEL_PATH: the ASR worker transcribes with weights loaded
    from an on-disk HF-format Whisper checkpoint."""
    _jax_whisper_checkpoint(tmp_path)
    mod = load_example("asr-worker")
    app = mod.build_app(cfg(MODEL_PATH=str(tmp_path)), device="cpu")
    with AppRunner(app=app) as runner:
        tone = np.sin(np.linspace(0, 440, 4000)).astype(np.float32)
        status, _, data = runner.request("POST", "/transcribe",
                                         {"audio": tone.tolist()})
        assert status == 201
        assert "tokens" in json.loads(data)["data"]


# ------------------------------------- same weights, same answers
def _jax_cfg(**kw):
    from gofr_tpu.config import DictConfig as JaxDictConfig
    return JaxDictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                          "APP_NAME": "example", **kw})


def _made(engine) -> list:
    """The requests ``engine`` is given from here on."""
    made, inner = [], engine.submit

    def submit(*args, **kwargs):
        made.append(inner(*args, **kwargs))
        return made[-1]

    engine.submit = submit
    return made


def _post(runner, path: str, body: dict) -> dict:
    status, _, data = runner.request("POST", path, body)
    assert status in (200, 201), data
    return json.loads(data)


def _counts(usage: dict) -> dict:
    """A usage record's token counts (its times are each run's own)."""
    return {k: v for k, v in usage.items() if k.endswith("_tokens")}


def test_model_serving_gives_jax_tokens_from_one_checkpoint(tmp_path):
    """Both examples boot from one JAX-written checkpoint (float32, so
    the two frameworks' greedy runs can be held equal): the same
    ``/chat`` tokens, the same ``/v1/completions`` text and usage, and
    equal ``request_digest`` for every request."""
    from .apputil import AppRunner as JaxAppRunner
    from .test_examples import load_example as load_jax_example
    _jax_llama_checkpoint(tmp_path)
    env = {"MODEL_PATH": str(tmp_path), "MODEL_MAX_SEQ": "128",
           "MODEL_DTYPE": "float32"}
    apps = {"jax": (load_jax_example("model-serving").build_app(
                        _jax_cfg(**env)), JaxAppRunner),
            "port": (load_example("model-serving").build_app(
                         cfg(**env), device="cpu"), AppRunner)}
    got = {}
    for side, (app, runner_cls) in apps.items():
        made = _made(app.container.get_model("llama"))
        with runner_cls(app=app) as runner:
            chats = [_post(runner, "/chat", {
                "prompt": prompt, "max_new_tokens": 9,
                "temperature": 0.0})["data"]
                for prompt in ("the cat", "the theme of the hat")]
            completion = _post(runner, "/v1/completions", {
                "model": tmp_path.name, "prompt": "at the cat",
                "max_tokens": 7, "temperature": 0.0})
        got[side] = ([c["tokens"] for c in chats],
                     [_counts(c["usage"]) for c in chats],
                     completion["choices"][0]["text"],
                     _counts(completion["usage"]),
                     [req.digest for req in made])
    assert got["port"] == got["jax"]
    assert [len(t) for t in got["port"][0]] == [9, 9]
    assert len(got["port"][4]) == 3 and all(got["port"][4])


def test_asr_worker_gives_jax_tokens_from_one_checkpoint(tmp_path):
    from .apputil import AppRunner as JaxAppRunner
    from .test_examples import load_example as load_jax_example
    _jax_whisper_checkpoint(tmp_path)
    env = {"MODEL_PATH": str(tmp_path), "MODEL_DTYPE": "float32"}
    apps = {"jax": (load_jax_example("asr-worker").build_app(
                        _jax_cfg(**env)), JaxAppRunner),
            "port": (load_example("asr-worker").build_app(
                         cfg(**env), device="cpu"), AppRunner)}
    rng = np.random.default_rng(5)
    audios = [np.sin(np.linspace(0, 440, 4000)).astype(np.float32),
              (0.1 * rng.standard_normal(9000)).astype(np.float32)]
    got = {}
    for side, (app, runner_cls) in apps.items():
        with runner_cls(app=app) as runner:
            got[side] = [_post(runner, "/transcribe",
                               {"audio": a.tolist()})["data"]["tokens"]
                         for a in audios]
    assert got["port"] == got["jax"]
    assert all(got["port"])


# ------------------------------------------------ the operator tools
def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _captured_workload(seed: int, prompts: list, n: int) -> str:
    """The JSONL capture of the port's demo engine serving ``prompts``
    greedily, one at a time."""
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.glue import demo_llama_engine
    eng = demo_llama_engine(EngineConfig(max_batch=4, max_seq=128,
                                         seed=seed, workload_capture=True),
                            device="cpu")
    eng.start()
    try:
        for prompt in prompts:
            req = eng.submit(prompt, SamplingParams(temperature=0.0,
                                                    max_new_tokens=n))
            assert req.done.wait(120) and req.error is None
    finally:
        eng.stop()
    return eng.workload.to_jsonl()


def test_capacity_pick_max_sustainable():
    capacity = _script("torch_capacity")
    levels = [{"concurrency": 1, "qps": 10, "tripped": False},
              {"concurrency": 2, "qps": 18, "tripped": False},
              {"concurrency": 4, "qps": 19, "tripped": True},
              {"concurrency": 8, "qps": 12, "tripped": False}]
    best = capacity.pick_max_sustainable(levels)
    assert best["concurrency"] == 2  # nothing past the first trip
    assert capacity.pick_max_sustainable(
        [{"concurrency": 1, "qps": 1, "tripped": True}]) is None


def test_capacity_sweep_reports_goodput_curve_and_the_router_reads_it(
        tmp_path):
    """Two lenient-SLO levels over a tiny workload captured from the
    port's demo engine: each level carries qps + goodput + burn state,
    the sweep names the max sustainable level, and the ``--json``
    setpoint file sets the port's router's setpoint."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import demo_llama_engine
    from gofr_tpu_torch.serving.observability import SLOConfig
    from gofr_tpu_torch.serving.replay import parse_workload
    from gofr_tpu_torch.serving.router import FleetRouter, RouterConfig
    capacity = _script("torch_capacity")
    workload = parse_workload(_captured_workload(
        9, [[2 + i, 4, 6] for i in range(4)], 8))
    eng = demo_llama_engine(EngineConfig(max_batch=4, max_seq=128, seed=9),
                            device="cpu")
    try:
        result = capacity.sweep(
            eng, workload, [1, 2],
            SLOConfig(ttft_s=60.0, tpot_s=60.0, e2e_s=120.0),
            timeout_s=120, log=lambda _m: None)
    finally:
        eng.stop()
    assert [e["concurrency"] for e in result["levels"]] == [1, 2]
    for entry in result["levels"]:
        assert entry["qps"] > 0
        assert 0.0 < entry["goodput_ratio"] <= 1.0
        assert not entry["tripped"]
    assert result["max_sustainable_concurrency"] == 2
    assert result["tripped_at"] is None

    path = tmp_path / "setpoint.json"
    path.write_text(json.dumps(capacity.setpoint_doc(result)))
    app = App(config=cfg())
    router = FleetRouter(object(), RouterConfig(
        autoscale=True, setpoint_file=str(path)),
        metrics=app.container.metrics)
    router.install(app)
    assert router.autoscaler.setpoint == 2


def _changed_token(text: str) -> str:
    """The workload with the first record's first generated token
    changed."""
    lines = text.splitlines()
    rec = json.loads(lines[1])
    rec["completion_tokens"][0] = (rec["completion_tokens"][0] + 1) % 256
    lines[1] = json.dumps(rec)
    return "\n".join(lines) + "\n"


def test_replay_tool_exits_0_and_2_on_a_changed_token(tmp_path):
    text = _captured_workload(4, [[5, 9, 2], [7, 7, 1, 3]], 6)
    good, bad = tmp_path / "good.jsonl", tmp_path / "bad.jsonl"
    good.write_text(text)
    bad.write_text(_changed_token(text))
    codes = {}
    for path in (good, bad):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_replay.py"),
             str(path), "--closed-loop", "1", "--max-seq", "128",
             "--device", "cpu", "--report", str(path) + ".report"],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        codes[path.name] = proc.returncode
        report = json.loads((tmp_path / (path.name + ".report"))
                            .read_text())
        assert report["compared"] == 2, proc.stderr
    assert codes == {"good.jsonl": 0, "bad.jsonl": 2}
    assert "# DIVERGED: 1 request(s)" in proc.stderr


def _bundle(port: int, out: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "bundle.py"),
         f"http://127.0.0.1:{port}", "--out", str(out)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(out.read_text())


def test_bundle_collects_from_a_port_app_what_it_collects_from_jax(
        tmp_path):
    """``scripts/bundle.py`` (it imports neither package) against an
    ``App.serve_model`` of each package, a workload captured on each:
    the same surfaces present, ``errors`` only for the fleet ones (a
    host that leads no fleet), and the port's workload holds its
    requests."""
    from gofr_tpu.app import App as JaxApp
    from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
    from gofr_tpu.serving.engine import SamplingParams as JaxSampling
    from gofr_tpu.serving.glue import demo_llama_engine as jax_demo
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.glue import demo_llama_engine

    from .apputil import AppRunner as JaxAppRunner
    sides = {
        "jax": (JaxApp(config=_jax_cfg()), jax_demo(JaxEngineConfig(
            max_batch=4, max_seq=128)), JaxSampling, JaxAppRunner),
        "port": (App(config=cfg()), demo_llama_engine(EngineConfig(
            max_batch=4, max_seq=128), device="cpu"), SamplingParams,
            AppRunner)}
    bundles = {}
    for side, (app, engine, sampling, runner_cls) in sides.items():
        app.serve_model("llama", engine)
        with runner_cls(app=app) as runner:
            status, _, _ = runner.request("POST", "/debug/workload/start",
                                          {})
            assert status in (200, 201)
            for prompt in ([5, 9, 2], [7, 7, 1, 3]):
                req = engine.submit(prompt, sampling(temperature=0.0,
                                                     max_new_tokens=4))
                deadline = time.time() + 120
                while req.finished_at is None and time.time() < deadline:
                    time.sleep(0.005)
                assert req.error is None
            bundles[side] = _bundle(runner.port, tmp_path / f"{side}.json")
    present = {side: {k for k, v in b.items() if v is not None}
               for side, b in bundles.items()}
    assert present["port"] == present["jax"]
    fleet = {"fleet", "fleet_events", "fleet_incidents"}
    for b in bundles.values():
        assert set(b["errors"]) == fleet
    lines = bundles["port"]["workload"].splitlines()
    assert json.loads(lines[0])["format"] == "gofr-workload"
    assert [json.loads(line)["prompt_tokens"] for line in lines[1:]] \
        == [[5, 9, 2], [7, 7, 1, 3]]


# ------------------------------------------- C13: the awaited client
def test_jax_async_handler_awaits_the_port_client_with_the_loop_live():
    """``examples/using-http-service``'s handler, verbatim, on a port
    ``App`` (the parity test holds its text equal to JAX's): ``await
    catalog.get(...)`` against a downstream that holds the answer. While
    the call is pending ``/.well-known/alive`` answers; then the proxy
    answers with the downstream's body."""
    from gofr_tpu_torch.app import App
    mod = load_example("using-http-service")
    entered, release = threading.Event(), threading.Event()
    downstream = App(config=cfg())

    @downstream.get("/items/{id}")
    def item(ctx):
        entered.set()
        release.wait(30)
        return {"id": ctx.path_param("id"), "price": 9.5}

    with AppRunner(app=downstream) as down:
        app = mod.build_app(cfg(),
                            downstream_url=f"http://127.0.0.1:{down.port}")
        with AppRunner(app=app) as runner:
            answer: dict = {}

            def proxy():
                answer["got"] = runner.get_json("/proxy/slow", timeout=30)
            caller = threading.Thread(target=proxy)
            caller.start()
            try:
                assert entered.wait(10)
                t0 = time.perf_counter()
                status, _, _ = runner.request("GET", "/.well-known/alive",
                                              timeout=5)
                alive_s = time.perf_counter() - t0
                assert "got" not in answer     # the call is still pending
            finally:
                release.set()
                caller.join(30)
    assert status == 200 and alive_s < 2.0
    status, body = answer["got"]
    assert status == 200
    assert body["data"]["data"] == {"id": "slow", "price": 9.5}


# ------------------------------- C19 / C32: the demo engine on the card
def test_demo_engine_models_jax_on_the_cpu_and_the_kernels_on_cuda():
    """``demo_llama_engine`` (the replay and capacity tools' engine)
    serves JAX's demo model (``LlamaConfig.tiny()``: float32, head_dim
    16) on the CPU and on CUDA alike: the kernels take its type and head
    dim, so the bf16 head_dim-64 twin the card once needed is gone."""
    import torch

    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import _check
    from gofr_tpu_torch.serving.glue import demo_config
    assert demo_config("cpu") == LlamaConfig.tiny()
    card = demo_config("cuda")
    assert card == LlamaConfig.tiny()
    assert (card.dtype, card.head_dim) == (torch.float32, 16)
    # the flash kernel's checks take its shapes (nothing is launched)
    q = torch.zeros(1, 8, card.n_heads, card.head_dim)
    kv = torch.zeros(1, 8, card.n_kv_heads, card.head_dim)
    _check(q, kv, kv, torch.full((1,), 8, dtype=torch.int32))


@pytest.mark.cuda
def test_replay_tool_on_the_card(tmp_path):
    """A workload captured from the demo engine on the card replays
    through ``scripts/torch_replay.py`` (default device) with exit 0."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.glue import demo_llama_engine
    eng = demo_llama_engine(EngineConfig(max_batch=4, max_seq=128, seed=4,
                                         workload_capture=True))
    eng.start()
    try:
        for prompt in ([5, 9, 2], [7, 7, 1, 3]):
            req = eng.submit(prompt, SamplingParams(temperature=0.0,
                                                    max_new_tokens=6))
            assert req.done.wait(120) and req.error is None
    finally:
        eng.stop()
    path = tmp_path / "card.jsonl"
    path.write_text(eng.workload.to_jsonl())
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_replay.py"),
         str(path), "--closed-loop", "1", "--max-seq", "128"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
