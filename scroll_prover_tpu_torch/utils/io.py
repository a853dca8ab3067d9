"""Artifact JSON io (reference: prover crate `dump_as_json`, `read_json`,
`read_json_deep`, `force_read` — SURVEY.md section 2.3)."""
from __future__ import annotations

import json
import os


def dump_as_json(dir_path: str, name: str, obj) -> str:
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"{name}.json")
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    return path


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def read_json_deep(dir_path: str, name: str):
    """Find `name` anywhere under dir_path (reference read_json_deep)."""
    for root, _dirs, files in os.walk(dir_path):
        if name in files:
            return read_json(os.path.join(root, name))
    raise FileNotFoundError(f"{name} not found under {dir_path}")


def force_read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()
