"""The serving planes' name for the port's one logger: everything here is
re-exported from :mod:`gofr_tpu_torch.logging.logger` (``Logger``, the
fleet context of :func:`set_fleet_context`), so the engine, the control
plane and the app log through the same class and the same fleet
context."""

from ..logging.logger import (Logger, clear_fleet_context,
                              current_fleet_context, set_fleet_context)

__all__ = ["Logger", "clear_fleet_context", "current_fleet_context",
           "set_fleet_context"]
