"""Cron scheduling (reference examples/using-cron-jobs): 5-field
schedules ticking inside the app process."""

import time

from gofr_tpu_torch.app import App, new_app

STATE = {"runs": 0, "last": None}


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)

    def heartbeat(ctx):
        STATE["runs"] += 1
        STATE["last"] = time.time()
        ctx.logger.info("heartbeat", runs=STATE["runs"])

    app.add_cron_job("* * * * *", "heartbeat", heartbeat)

    @app.get("/runs")
    def runs(ctx):
        return dict(STATE)

    return app


if __name__ == "__main__":
    build_app().run()
