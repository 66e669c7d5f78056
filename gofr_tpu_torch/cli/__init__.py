"""CLI runtime: subcommand apps + terminal TUI toolkit (the port's copy of
``gofr_tpu/cli/``)."""

from .cmd import CMDApp
from .request import CMDRequest, parse_args
from .terminal import Out, ProgressBar, Spinner

__all__ = ["CMDApp", "CMDRequest", "parse_args", "Out", "Spinner",
           "ProgressBar"]
