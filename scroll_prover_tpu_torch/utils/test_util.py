"""Trace fixture loading (reference integration/src/test_util.rs).

`load_chunk` globs `block_*.json` with numeric sort (test_util.rs:43-50);
`load_batch` collects sorted `chunk_*` directories (test_util.rs:58).
"""
from __future__ import annotations

import glob
import os
import re

from ..l2types.block_trace import BlockTrace, get_block_trace_from_file

ASSETS_DIR = "./test_assets"
PARAMS_DIR = "./params"


def trace_path_for_test(default: str | None = None) -> str:
    return os.environ.get(
        "TRACE_PATH", default or "tests/extra_traces/batch1"
    )


def _numeric_key(path: str):
    m = re.search(r"(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def load_chunk(path: str) -> list[BlockTrace]:
    """A chunk directory (or single file) -> numerically sorted traces."""
    if os.path.isfile(path):
        return [get_block_trace_from_file(path)]
    files = glob.glob(os.path.join(path, "block_*.json"))
    if not files:
        files = glob.glob(os.path.join(path, "*.json"))
    files.sort(key=_numeric_key)
    return [get_block_trace_from_file(f) for f in files]


def load_batch(path: str) -> list[list[BlockTrace]]:
    """A batch directory of chunk_* subdirs -> list of chunks."""
    chunk_dirs = sorted(
        (d for d in glob.glob(os.path.join(path, "chunk_*")) if os.path.isdir(d)),
        key=_numeric_key,
    )
    return [load_chunk(d) for d in chunk_dirs]
