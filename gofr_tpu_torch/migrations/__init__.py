"""Versioned datasource migrations with per-store ledgers (the port's
copy of ``gofr_tpu/migrations/``)."""

from .runner import Datasource, Migrate, MigrationError, run

__all__ = ["Migrate", "Datasource", "MigrationError", "run"]
