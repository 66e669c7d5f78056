"""gofrlint ruleset. Each rule module exposes RULE_ID and
``run(project, graph) -> list[Finding]``; the registry here is what the
CLI and the analyzer driver iterate (the port's copy of
``gofr_tpu/analysis/rules/__init__.py``)."""

from __future__ import annotations

from . import (async_blocking, hot_path, kv_quant, locks,
               metric_hygiene, recompile)

ALL_RULES = (hot_path, locks, async_blocking, metric_hygiene, recompile,
             kv_quant)

RULE_IDS = tuple(r.RULE_ID for r in ALL_RULES)
