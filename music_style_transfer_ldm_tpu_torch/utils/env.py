"""A minimal .env loader: KEY=VALUE lines of ``.env.local`` (or another
file) into ``os.environ``, with no python-dotenv."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def load_env_file(path: str | Path = ".env.local",
                  override: bool = False) -> dict:
    """Load KEY=VALUE pairs (blank lines, ``#`` comments and lines without
    ``=`` skipped; the first ``=`` splits; quotes stripped) and return
    what was parsed.  A variable already set wins unless ``override``.
    A missing file gives {}."""
    path = Path(path)
    parsed: dict = {}
    if not path.exists():
        return parsed
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("'\"")
        parsed[key] = value
        if override or key not in os.environ:
            os.environ[key] = value
    return parsed


def get_env(key: str, default: Optional[str] = None,
            env_file: str | Path = ".env.local") -> Optional[str]:
    """``os.environ[key]``, else the value in ``env_file``, else
    ``default``."""
    if key in os.environ:
        return os.environ[key]
    return load_env_file(env_file).get(key, default)
