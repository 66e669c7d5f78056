"""The port's CLI (``gofr_tpu_torch/cli/``, ``app.new_cmd``) against the
JAX package's: every case of ``tests/test_cli.py`` runs on both packages
(``S``); the same argv sequences, fixed and seeded at random over
``parse_args``'s forms, give the same stdout, stderr and exit codes
through both ``CMDApp``s; and a ``generate`` subcommand on the tiny Llama
config gives the JAX engine's tokens and ``request_digest`` on the same
prompts, its engine reached through ``ctx.model`` as an ``App`` handler
reaches it.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import time

import numpy as np
import pytest

from .torch_wire import Side as _Side

SIDES = ["port", "jax"]
_MODULES = ("cli", "cli.request", "cli.terminal", "cli.cmd", "config",
            "app", "context")


def Side(side: str) -> _Side:
    return _Side(side, _MODULES)


@pytest.fixture(params=SIDES)
def S(request):
    return Side(request.param)


def make_app(S, name="tool"):
    app = S.CMDApp(config=S.DictConfig({"APP_NAME": name}))
    stdout, stderr = io.StringIO(), io.StringIO()
    app.out = S.Out(stream=stdout, force_tty=False)
    app.err_out = S.Out(stream=stderr, force_tty=False)
    return app, stdout, stderr


# ------------------------------------------------- tests/test_cli.py's 20
class TestParseArgs:
    def test_forms(self, S):
        pos, flags = S.parse_args(["db", "migrate", "-n=5", "--env=prod",
                                   "-v", "--dry-run"])
        assert pos == ["db", "migrate"]
        assert flags["n"] == ["5"]
        assert flags["env"] == ["prod"]
        assert flags["v"] == ["true"]
        assert flags["dry-run"] == ["true"]

    def test_bare_flag_does_not_swallow_positional(self, S):
        _, flags = S.parse_args(["greet", "--help", "extra"])
        assert flags["help"] == ["true"]
        assert flags["_args"] == ["extra"]

    def test_hyphenated_flags_bind_underscore_fields(self, S):
        request = S.CMDRequest(["migrate", "--dry-run"])
        assert request.bind()["dry_run"] == "true"

    def test_repeat_and_csv_params(self, S):
        request = S.CMDRequest(["x", "-t=a", "-t=b,c"])
        assert request.params("t") == ["a", "b", "c"]
        assert request.param("t") == "a"
        assert request.param("missing") == ""


@dataclasses.dataclass
class MigrateArgs:
    env: str
    n: int = 1
    dry_run: bool = False


class TestCMDApp:
    def test_routing_and_result_printing(self, S):
        app, stdout, _ = make_app(S)
        app.sub_command("greet", lambda ctx: f"hello {ctx.param('name')}")
        assert app.run(["greet", "-name=ada"]) == 0
        assert stdout.getvalue().strip() == "hello ada"

    def test_longest_prefix_wins(self, S):
        app, stdout, _ = make_app(S)
        app.sub_command("db", lambda ctx: "db root")
        app.sub_command("db migrate", lambda ctx: "migrating")
        assert app.run(["db", "migrate"]) == 0
        assert stdout.getvalue().strip() == "migrating"

    def test_dataclass_bind(self, S):
        app, stdout, _ = make_app(S)

        @app.sub_command("migrate")
        def migrate(ctx):
            args = ctx.bind(MigrateArgs)
            return {"env": args.env, "n": args.n, "dry": args.dry_run}
        assert app.run(["migrate", "--env=prod", "-n=3"]) == 0
        out = stdout.getvalue()
        assert '"env": "prod"' in out and '"n": 3' in out

    def test_dict_result_prints_json(self, S):
        app, stdout, _ = make_app(S)
        app.sub_command("info", lambda ctx: {"version": 1})
        app.run(["info"])
        assert '"version": 1' in stdout.getvalue()

    def test_error_goes_to_stderr_with_exit_code(self, S):
        app, stdout, stderr = make_app(S)

        def boom(ctx):
            raise ValueError("bad input")
        app.sub_command("boom", boom)
        assert app.run(["boom"]) == 1
        assert "bad input" in stderr.getvalue()
        assert stdout.getvalue() == ""

    def test_async_handler(self, S):
        app, stdout, _ = make_app(S)

        @app.sub_command("async")
        async def handler(ctx):
            return "done"
        assert app.run(["async"]) == 0
        assert "done" in stdout.getvalue()

    def test_help_listing(self, S):
        app, stdout, _ = make_app(S)
        app.sub_command("serve", lambda ctx: None,
                        description="start the server")
        app.sub_command("migrate", lambda ctx: None,
                        description="run migrations")
        assert app.run(["help"]) == 0
        out = stdout.getvalue()
        assert "serve" in out and "start the server" in out
        assert "migrate" in out and "run migrations" in out

    def test_help_flag_on_matched_subcommand(self, S):
        app, stdout, _ = make_app(S)
        ran = []
        app.sub_command("greet", lambda ctx: ran.append(1) or "hi",
                        description="say hello")
        assert app.run(["greet", "--help"]) == 0
        assert ran == []
        assert "say hello" in stdout.getvalue()

    def test_unknown_command_shows_help_exit_2(self, S):
        app, stdout, _ = make_app(S)
        app.sub_command("serve", lambda ctx: None, description="x")
        assert app.run(["nope"]) == 2
        assert "serve" in stdout.getvalue()

    def test_terminal_attached_to_context(self, S):
        app, stdout, _ = make_app(S)

        @app.sub_command("draw")
        def draw(ctx):
            ctx.terminal.print(ctx.terminal.green("ok"))
            return None
        assert app.run(["draw"]) == 0
        assert "ok" in stdout.getvalue()

    def test_container_reachable(self, S):
        app, stdout, _ = make_app(S)
        app.sub_command("name", lambda ctx: ctx.container.app_name)
        app.run(["name"])
        assert "tool" in stdout.getvalue()


class TestTerminal:
    def test_colors_only_on_tty(self, S):
        plain = S.Out(stream=io.StringIO(), force_tty=False)
        assert plain.green("x") == "x"
        tty = S.Out(stream=io.StringIO(), force_tty=True)
        assert tty.green("x") == "\x1b[32mx\x1b[0m"
        assert tty.bold("x") == "\x1b[1mx\x1b[0m"

    def test_progress_bar_tty_renders_bar(self, S):
        stream = io.StringIO()
        out = S.Out(stream=stream, force_tty=True)
        bar = S.ProgressBar(out, total=4, width=8)
        bar.increment()
        bar.set(4)
        text = stream.getvalue()
        assert "25%" in text and "100%" in text and "█" in text

    def test_progress_bar_plain_prints_milestones(self, S):
        stream = io.StringIO()
        out = S.Out(stream=stream, force_tty=False)
        bar = S.ProgressBar(out, total=10, width=8)
        for _ in range(10):
            bar.increment()
        text = stream.getvalue()
        assert "progress: 100%" in text
        assert "█" not in text

    def test_spinner_plain_mode(self, S):
        stream = io.StringIO()
        out = S.Out(stream=stream, force_tty=False)
        with out.spinner("working"):
            pass
        assert "working..." in stream.getvalue()

    def test_spinner_tty_animates(self, S):
        stream = io.StringIO()
        out = S.Out(stream=stream, force_tty=True)
        with out.spinner("load"):
            time.sleep(0.2)
        assert "load" in stream.getvalue()


# ------------------------------------------------------ the port's context
def test_context_takes_responder_and_terminal_as_jax_does():
    from gofr_tpu_torch.container.container import Container
    from gofr_tpu_torch.context import Context
    responder, terminal = object(), object()
    ctx = Context(request=None, container=Container(),
                  responder=responder, terminal=terminal)
    assert ctx.responder is responder and ctx.terminal is terminal
    plain = Context(request=None, container=Container())
    assert plain.responder is None and plain.terminal is None


def test_new_cmd_builds_a_cmd_app_on_the_port():
    from gofr_tpu_torch.app import new_cmd
    from gofr_tpu_torch.cli import CMDApp
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container.container import Container
    app = new_cmd(config=DictConfig({"APP_NAME": "tool"}))
    assert isinstance(app, CMDApp) and isinstance(app.container, Container)
    assert app.container.app_name == "tool"


# ------------------------------------------------------------ argv parity
def _register(S, app):
    """The same subcommands on either package's app."""
    app.sub_command("greet", lambda ctx: f"hello {ctx.param('name')}",
                    description="say hello", help="-name=<who>")
    app.sub_command("db", lambda ctx: "db root", description="db tools")
    app.sub_command("db migrate",
                    lambda ctx: {"args": ctx.bind(),
                                 "t": ctx.params("t")},
                    description="run migrations")
    app.sub_command("boom", _boom, description="always fails")
    app.sub_command("none", lambda ctx: None)
    app.sub_command("raw", lambda ctx: b"raw bytes\n")
    app.sub_command("list", lambda ctx: [ctx.param("n"), ctx.params("x")])

    @app.sub_command("async", description="a coroutine handler")
    async def _async(ctx):
        return {"positionals": ctx.request.positionals}

    @app.sub_command("draw")
    def _draw(ctx):
        ctx.terminal.print(ctx.terminal.bold("drawn"))
        return ctx.param("v")


def _boom(ctx):
    raise ValueError(f"bad input {ctx.param('n')}")


def _run_argv(side: str, argv: list[str]) -> tuple[int, str, str]:
    S = Side(side)
    app, stdout, stderr = make_app(S)
    _register(S, app)
    code = app.run(argv)
    return code, stdout.getvalue(), stderr.getvalue()


FIXED_ARGV = [
    [], ["help"], ["-h"], ["--help"], ["greet", "-name=ada"],
    ["greet", "--help"], ["greet", "-h=true"], ["db"], ["db", "migrate"],
    ["db", "migrate", "-n=5", "--env=prod", "-v", "--dry-run"],
    ["db", "migrate", "-t=a", "-t=b,c", "stray"], ["db", "nope"],
    ["nope"], ["boom", "-n=3"], ["none"], ["raw"], ["list", "-x=1,2"],
    ["async", "--flag"], ["draw", "-v=7"], ["-", "--"], ["greet", "-"],
]


@pytest.mark.parametrize("argv", FIXED_ARGV, ids=lambda a: " ".join(a) or
                         "<empty>")
def test_argv_gives_jax_stdout_stderr_and_exit_code(argv):
    assert _run_argv("port", argv) == _run_argv("jax", argv)


_WORDS = ["db", "migrate", "greet", "boom", "x", "none", "raw", "list",
          "async", "draw", "-", "--"]
_FLAGS = ["-n=5", "--env=prod", "-v", "--dry-run", "-t=a,b", "-t=c",
          "-x=", "--help", "-h", "-name=ada", "--a=b=c", "---z", "-=q"]


@pytest.mark.parametrize("seed", range(8))
def test_seeded_random_argv_agree(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n_words = int(rng.integers(0, 4))
        n_flags = int(rng.integers(0, 5))
        argv = [str(rng.choice(_WORDS)) for _ in range(n_words)]
        argv += [str(rng.choice(_FLAGS + _WORDS)) for _ in range(n_flags)]
        port = importlib.import_module("gofr_tpu_torch.cli.request")
        jax_ = importlib.import_module("gofr_tpu.cli.request")
        assert port.parse_args(argv) == jax_.parse_args(argv), argv
        p, j = port.CMDRequest(argv), jax_.CMDRequest(argv)
        assert (p.subcommand, p.bind(), p.params("t"), p.param("n")) == \
            (j.subcommand, j.bind(), j.params("t"), j.param("n")), argv
        assert _run_argv("port", argv) == _run_argv("jax", argv), argv


def test_tty_output_agrees():
    got = {}
    for side in SIDES:
        S = Side(side)
        stream = io.StringIO()
        out = S.Out(stream=stream, force_tty=True)
        out.print(out.red("r") + out.yellow("y") + out.cyan("c") +
                  out.color("m", "magenta"))
        out.printf("%d-%s\n", 3, "x")
        out.clear_line()
        out.move_cursor_up(2)
        out.hide_cursor()
        out.show_cursor()
        bar = S.ProgressBar(out, total=3, width=6)
        for _ in range(3):
            bar.increment()
        got[side] = stream.getvalue()
    assert got["port"] == got["jax"]


# ------------------------------------------------- generate on the engine
def _generate_handler(S, sampling_cls, digest_fn):
    """A ``generate`` subcommand as a user writes it: the engine from
    ``ctx.model``, the prompt's ids from ``--tokens``, greedy."""
    def generate(ctx):
        engine = ctx.model("llama")
        ids = [int(t) for t in ctx.params("tokens")]
        req = engine.submit(ids, sampling_cls(
            temperature=0.0, max_new_tokens=int(ctx.param("max_tokens"))))
        deadline = time.time() + 120
        while req.finished_at is None and req.error is None and \
                time.time() < deadline:
            time.sleep(0.005)
        if req.error is not None:
            raise RuntimeError(req.error)
        return {"tokens": list(req.generated),
                "request_digest": digest_fn(req.prompt_tokens, req.params,
                                            req.generated)}
    return generate


def test_generate_subcommand_gives_jax_tokens_and_digest():
    import jax
    import torch

    from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from gofr_tpu.models.llama import llama_init as jax_llama_init
    from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
    from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
    from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
    from gofr_tpu.serving.integrity import request_digest as jax_digest
    from gofr_tpu_torch.models.convert import params_from_jax
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.integrity import request_digest

    torch.set_num_threads(2)
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny(), "cpu")
    common = dict(max_batch=2, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefix_cache=False)
    engines = {
        "jax": jax_llama_engine(
            jparams, JaxLlamaConfig.tiny(),
            JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                            compile_cache_dir=None, **common),
            implementation="xla"),
        "port": llama_engine(tparams, LlamaConfig.tiny(),
                             EngineConfig(**common), device="cpu")}
    handlers = {"jax": (JaxSamplingParams, jax_digest),
                "port": (SamplingParams, request_digest)}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (7, 30, 50)]
    outs = {}
    for side in ("jax", "port"):
        S = Side(side)
        app, stdout, stderr = make_app(S)
        app.container.add_model("llama", engines[side])
        app.sub_command("generate", _generate_handler(S, *handlers[side]))
        engines[side].start()
        try:
            runs = []
            for p in prompts:
                code = app.run(["generate",
                                "--tokens=" + ",".join(map(str, p)),
                                "--max_tokens=9"])
                assert code == 0, stderr.getvalue()
                runs.append(json.loads(stdout.getvalue()))
                stdout.seek(0)
                stdout.truncate()
        finally:
            engines[side].stop()
        outs[side] = runs
    assert len(outs["port"]) == len(prompts)
    assert all(len(r["tokens"]) == 9 for r in outs["port"])
    assert outs["port"] == outs["jax"]
    for p, run in zip(prompts, outs["port"]):
        assert run["request_digest"] == jax_digest(
            p, JaxSamplingParams(temperature=0.0, max_new_tokens=9),
            run["tokens"])
