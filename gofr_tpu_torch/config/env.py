"""Environment-file configuration with GoFr's precedence semantics (the
port's copy of ``gofr_tpu/config/env.py``).

The reference loads ``./configs/.env`` then overlays
``./configs/.{APP_ENV}.env``, with real OS environment variables always
winning (reference: pkg/gofr/config/godotenv.go:29-77, config/config.go:3-6).
This module reimplements that contract for the TPU build: a ``Config``
protocol with ``get``/``get_or_default`` and an ``EnvConfig`` that reads
env files into a layered map.

No third-party dotenv dependency: the parser handles comments, blank
lines, ``export`` prefixes, single/double quotes, and ``KEY=VALUE`` pairs.

Left out: the JAX module's compilation-cache helpers
(``default_compile_cache_dir``, ``resolve_compile_cache_dir``,
``enable_compile_cache``), which point XLA's persistent cache at a
directory. The port compiles no XLA programs: its CUDA kernels and
native libraries build once into the git-ignored ``build/`` directory
(``ops/_build.py``, ``native/build.py``) and are reused from there.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Protocol


class Config(Protocol):
    """Read-only config surface handed to every subsystem.

    Mirrors the two-method interface at reference config/config.go:3-6.
    """

    def get(self, key: str) -> str | None: ...

    def get_or_default(self, key: str, default: str) -> str: ...


def _parse_env_line(line: str) -> tuple[str, str] | None:
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if line.startswith("export "):
        line = line[len("export "):].lstrip()
    if "=" not in line:
        return None
    key, _, value = line.partition("=")
    key = key.strip()
    if not key:
        return None
    value = value.strip()
    # Strip one layer of matching quotes; keep inline `#` inside quotes.
    if len(value) >= 2 and value[0] == value[-1] and value[0] in ("'", '"'):
        value = value[1:-1]
    else:
        # Unquoted values lose trailing comments.
        hash_idx = value.find(" #")
        if hash_idx != -1:
            value = value[:hash_idx].rstrip()
    return key, value


def load_env_file(path: str | Path) -> dict[str, str]:
    """Parse a dotenv file into a dict. Missing file -> empty dict."""
    out: dict[str, str] = {}
    p = Path(path)
    if not p.is_file():
        return out
    for line in p.read_text().splitlines():
        kv = _parse_env_line(line)
        if kv is not None:
            out[kv[0]] = kv[1]
    return out


class EnvConfig:
    """Layered env config: ``.env`` -> ``.{APP_ENV}.env`` -> OS env (wins).

    ``configs_dir`` defaults to ``./configs`` like the reference
    (pkg/gofr/gofr.go:187 readConfig).
    """

    def __init__(self, configs_dir: str | Path = "configs",
                 environ: Mapping[str, str] | None = None) -> None:
        self._environ: Mapping[str, str] = environ if environ is not None else os.environ
        base = Path(configs_dir)
        layered: dict[str, str] = {}
        layered.update(load_env_file(base / ".env"))
        app_env = self._environ.get("APP_ENV") or layered.get("APP_ENV")
        if app_env:
            layered.update(load_env_file(base / f".{app_env}.env"))
        self._file_values = layered

    def get(self, key: str) -> str | None:
        if key in self._environ:
            return self._environ[key]
        return self._file_values.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        value = self.get(key)
        return value if value not in (None, "") else default

    def get_int(self, key: str, default: int) -> int:
        try:
            return int(self.get_or_default(key, str(default)))
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        try:
            return float(self.get_or_default(key, str(default)))
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        value = self.get(key)
        if value is None or value == "":
            return default
        return value.strip().lower() in ("1", "true", "yes", "on")


class DictConfig:
    """In-memory config for tests and embedding (no files, no OS env)."""

    def __init__(self, values: Mapping[str, str] | None = None) -> None:
        self._values = dict(values or {})

    def get(self, key: str) -> str | None:
        return self._values.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        value = self._values.get(key)
        return value if value not in (None, "") else default

    def get_int(self, key: str, default: int) -> int:
        try:
            return int(self.get_or_default(key, str(default)))
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        try:
            return float(self.get_or_default(key, str(default)))
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        value = self._values.get(key)
        if value is None or value == "":
            return default
        return value.strip().lower() in ("1", "true", "yes", "on")

    def set(self, key: str, value: str) -> None:
        self._values[key] = value
