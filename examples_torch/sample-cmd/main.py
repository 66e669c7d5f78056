"""CLI app (reference examples/sample-cmd): subcommands on argv with
the same Handler signature as HTTP routes."""

from dataclasses import dataclass

from gofr_tpu_torch.cli.cmd import CMDApp


@dataclass
class GreetArgs:
    name: str = "world"
    shout: bool = False


def build_app(config=None) -> CMDApp:
    app = CMDApp(config=config)

    @app.sub_command("greet", help="print a greeting")
    def greet(ctx):
        args = ctx.bind(GreetArgs)
        message = f"hello {args.name}"
        return message.upper() if args.shout else message

    @app.sub_command("version", help="print the framework version")
    def version(ctx):
        from gofr_tpu_torch.version import FRAMEWORK
        return FRAMEWORK

    return app


if __name__ == "__main__":
    raise SystemExit(build_app().run())
