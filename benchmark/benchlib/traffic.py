"""The traffic generator's entry. A traffic mix is a JSON file of
parameters under traffic/; its "kind" names a generator module under
generators/ (`generators/<kind>.py`, found by name, so that a new kind is
a new file), whose `make(p, rng, task_seed)` returns one task's inputs.
Every input is drawn from (--seed, task index), so the same seed gives the
same tasks.
"""
from __future__ import annotations

import hashlib
import os
import random

GENERATORS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "generators")
_loaded: dict = {}


def use_generators(path: str) -> None:
    """Find the kinds' modules under `path` (the cell's benchmark folder's)."""
    global GENERATORS
    if path != GENERATORS:
        GENERATORS = path
        _loaded.clear()


def task_rng(seed: int, index: int, tag: str = "") -> random.Random:
    """A generator of its own for each (seed, task, tag)."""
    digest = hashlib.sha256(f"{seed}:{index}:{tag}".encode()).digest()
    return random.Random(int.from_bytes(digest, "little"))


def task_seed(seed: int, index: int, tag: str) -> bytes:
    """32 bytes for a task's blinding or a set-up's SRS, from the seed."""
    return hashlib.sha256(f"{seed}:{index}:{tag}".encode()).digest()


def generator(kind: str):
    """The module of a traffic kind, `generators/<kind>.py`."""
    if kind not in _loaded:
        from .cells import load_module

        path = os.path.join(GENERATORS, f"{kind}.py")
        if not os.path.exists(path):
            raise ValueError(f"unknown traffic kind {kind!r}: no {path}")
        _loaded[kind] = load_module(path, f"bench_generator_{kind}")
    return _loaded[kind]


def make_task(p: dict, seed: int, index: int) -> dict:
    """The inputs of task `index` (set-up uses index -1) of a run."""
    return generator(p["kind"]).make(p, task_rng(seed, index, p["kind"]),
                                     lambda tag: task_seed(seed, index, tag))
