"""Markers gofrlint keys on. Zero runtime behavior (the port's copy of
``gofr_tpu/analysis/annotations.py``).

``@hot_path`` tags a function as steady-state hot: gofrlint walks it and
everything it statically calls within the package and rejects host
syncs, wall-clock reads, logging, and metric writes (rule
``hot-path-purity``). The decorator itself only sets an attribute — the
engine pays nothing for being annotated.

``@hot_path_boundary(reason)`` tags a function as a deliberate exit
from the hot path — the retire/collect/failure boundaries where the
engine is *supposed* to assemble observability host-side. The purity
walk stops at a boundary instead of descending into it. The reason is
mandatory and shows up in ``scripts/lint.py --explain``-style output so
a reviewer can audit why the boundary is legitimate.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

HOT_PATH_ATTR = "__gofr_hot_path__"
BOUNDARY_ATTR = "__gofr_hot_path_boundary__"


def hot_path(fn: F) -> F:
    """Mark ``fn`` as steady-state hot. gofrlint enforces purity over
    ``fn`` and its static callees (see rule ``hot-path-purity``)."""
    setattr(fn, HOT_PATH_ATTR, True)
    return fn


def hot_path_boundary(reason: str) -> Callable[[F], F]:
    """Mark a function as a deliberate hot-path exit (retire/collect/
    failure handling). ``reason`` is mandatory — an empty reason is a
    lint error (``bad-suppression``), same contract as inline allows."""
    if not isinstance(reason, str) or not reason.strip():
        raise ValueError("hot_path_boundary requires a non-empty reason")

    def mark(fn: F) -> F:
        setattr(fn, BOUNDARY_ATTR, reason)
        return fn

    return mark
