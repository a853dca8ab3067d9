"""Env-var flag system + per-run output directories + logging.

The reference's primary config mechanism is env vars read at entry points
(SURVEY.md section 5 "Config/flag system"); `init_env_and_log(name)` creates
`outputs/<name>_<timestamp>/` and configures logging (reference: prover
crate `init_env_and_log`, used at e.g. integration/tests/e2e_tests.rs:32).
"""
from __future__ import annotations

import logging
import os
import subprocess
import time


def read_env_var(name: str, default):
    """Typed env read (reference test_util.rs:24)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    return raw


def init_env_and_log(name: str) -> str:
    """Create the run output dir and wire logging; returns the dir path."""
    ts = time.strftime("%Y%m%d_%H%M%S")
    base = read_env_var("SCROLL_PROVER_OUTPUT_DIR", "outputs")
    out = os.path.join(base, f"{name}_{ts}")
    os.makedirs(out, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    fh = logging.FileHandler(os.path.join(out, f"{name}.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logging.getLogger().addHandler(fh)
    return out


def short_git_version() -> str:
    """7-hex-char git id (reference unit_tests.rs:13-20)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=7", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        )
        v = out.stdout.strip()
        return v if len(v) >= 7 else "0000000"
    except Exception:
        return "0000000"
