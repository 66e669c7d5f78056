"""Websocket endpoint (reference examples/using-web-socket): the
handler runs once per inbound frame — ctx.bind() is the message, the
return value is written back; ctx.write_message_to_socket streams."""

from gofr_tpu_torch.app import App, new_app


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)

    @app.websocket("/ws/echo")
    def echo(ctx):
        return {"echo": ctx.bind(str)}

    @app.websocket("/ws/count")
    async def count(ctx):
        n = int(ctx.bind(str))
        for i in range(n):
            await ctx.write_message_to_socket({"tick": i})
        return {"done": n}

    return app


if __name__ == "__main__":
    build_app().run()
