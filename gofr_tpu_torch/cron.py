"""In-process cron scheduler (the port's copy of ``gofr_tpu/cron.py``).

Mirrors reference pkg/gofr/cron.go: 5-field (min hour dom mon dow) or
6-field (leading seconds) schedules parsed into match sets
(cron.go:16-25), a ticker loop that fires matching jobs each tick in
their own task with a fresh context and panic recovery (cron.go:69-73),
registered via ``app.add_cron_job`` (gofr.go:287).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Callable

from .context import Context
from .handler import run_handler


class CronParseError(ValueError):
    pass


# field bounds: sec min hour dom mon dow (5-field specs get sec=0 prepended)
_FIELD_RANGES = [(0, 59), (0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


def _parse_field(spec: str, lo: int, hi: int) -> frozenset[int]:
    values: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError as exc:
                raise CronParseError(f"bad step {step_s!r}") from exc
            if step < 1:
                raise CronParseError(f"bad step {step}")
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            try:
                lo2, hi2 = int(a), int(b)
            except ValueError as exc:
                raise CronParseError(f"bad range {part!r}") from exc
        else:
            try:
                lo2 = hi2 = int(part)
            except ValueError as exc:
                raise CronParseError(f"bad value {part!r}") from exc
        if lo2 < lo or hi2 > hi or lo2 > hi2:
            raise CronParseError(f"value {part!r} outside {lo}-{hi}")
        values.update(range(lo2, hi2 + 1, step))
    return frozenset(values)


@dataclass
class Schedule:
    seconds: frozenset[int]
    minutes: frozenset[int]
    hours: frozenset[int]
    days: frozenset[int]
    months: frozenset[int]
    weekdays: frozenset[int]

    @classmethod
    def parse(cls, spec: str) -> "Schedule":
        fields = spec.split()
        if len(fields) == 5:
            fields = ["0"] + fields  # fire at second 0 of matching minutes
        if len(fields) != 6:
            raise CronParseError(
                f"schedule needs 5 or 6 fields, got {len(fields)}: {spec!r}")
        parsed = [_parse_field(f, lo, hi)
                  for f, (lo, hi) in zip(fields, _FIELD_RANGES)]
        return cls(*parsed)

    def matches(self, t: time.struct_time) -> bool:
        return (t.tm_sec in self.seconds
                and t.tm_min in self.minutes
                and t.tm_hour in self.hours
                and t.tm_mday in self.days
                and t.tm_mon in self.months
                and t.tm_wday in self._py_weekdays())

    def _py_weekdays(self) -> frozenset[int]:
        # cron: 0=Sunday; python struct_time: 0=Monday
        return frozenset((d - 1) % 7 for d in self.weekdays)


@dataclass
class Job:
    name: str
    schedule: Schedule
    fn: Callable


class _TickRequest:
    """Context 'request' for cron jobs (implements the Request protocol)."""

    def __init__(self, name: str) -> None:
        self.name = name

    def param(self, key: str) -> str:
        return ""

    def params(self, key: str) -> list[str]:
        return []

    def path_param(self, key: str) -> str:
        return ""

    def bind(self, target=None):
        return None

    def host_name(self) -> str:
        return "cron"


class Cron:
    """1-second ticker; each matching job runs as its own task."""

    def __init__(self, container, executor=None) -> None:
        self.container = container
        #: where a plain job runs (the app's handler pool), never on the
        #: loop's thread
        self.executor = executor
        self.jobs: list[Job] = []
        self._tasks: set = set()

    def add(self, spec: str, name: str, fn: Callable) -> None:
        self.jobs.append(Job(name=name, schedule=Schedule.parse(spec), fn=fn))

    async def run(self) -> None:
        last_tick = int(time.time())
        while True:
            await asyncio.sleep(0.25)
            now = int(time.time())
            # fire each whole second exactly once, catching up if late
            for sec in range(last_tick + 1, now + 1):
                t = time.localtime(sec)
                for job in self.jobs:
                    if job.schedule.matches(t):
                        task = asyncio.ensure_future(self._run_job(job))
                        self._tasks.add(task)
                        task.add_done_callback(self._tasks.discard)
            last_tick = now

    async def _run_job(self, job: Job) -> None:
        ctx = Context(request=_TickRequest(job.name), container=self.container)
        try:
            await run_handler(job.fn, ctx, executor=self.executor)
        except Exception as exc:  # panic recovery per job
            self.container.logger.error(f"cron job {job.name!r} failed: {exc!r}")
