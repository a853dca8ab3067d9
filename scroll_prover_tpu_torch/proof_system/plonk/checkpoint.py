"""Phase-level checkpoint/resume for production-scale proves.

A prove at the reference's degrees (24 to 26) runs for a long time, and a
crash or an out-of-memory error kills the process but not the math: the
transcript is deterministic given (witness, blinding seed), so every phase
that was committed can be replayed from its recorded bytes without running
its MSMs again.

ProveCheckpoint memoizes the prover's expensive units on disk:

  * seed          — the blinding seed (fixed for the proof's lifetime)
  * points(tag)   — commitment groups (advice / permuted / grand-product /
                    quotient / multiopen, keygen's fixed and sigma), stored
                    as hex pairs
  * lookup(li)    — per-lookup host columns a/s/a_perm/s_perm as packed
                    (n, 8) u32 npz (the readback and the permutation)
  * coset(r)      — per-coset quotient accumulator, packed (n, 8) u32
                    Montgomery words in an npy
  * scalars(tag)  — evaluation lists

On resume the prover re-executes the cheap work (encode/upload, grand-product
scans) but skips every cached MSM, lookup permutation and quotient coset,
and the transcript replays bit-identically: the challenges and the final
proof bytes are those of an uninterrupted run.

The files are those the JAX package writes (same names, same JSON keys,
same array layouts), so a directory written by either package resumes in
the other.
"""
from __future__ import annotations

import json
import os

import numpy as np

_META = "meta.json"


class ProveCheckpoint:
    """Directory-backed memo store for one (circuit, witness, k) prove."""

    def __init__(self, dirpath: str, fingerprint: str):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.meta_path = os.path.join(dirpath, _META)
        self.meta: dict = {}
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as fh:
                self.meta = json.load(fh)
            if self.meta.get("fingerprint") != fingerprint:
                # a checkpoint of another circuit or witness: start over
                for f in os.listdir(dirpath):
                    os.remove(os.path.join(dirpath, f))
                self.meta = {}
        if not self.meta:
            self.meta = {
                "fingerprint": fingerprint,
                "seed": os.urandom(32).hex(),
                "points": {},
                "scalars": {},
            }
            self._flush()

    def _flush(self) -> None:
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.meta, fh)
        os.replace(tmp, self.meta_path)

    @property
    def seed(self) -> bytes:
        return bytes.fromhex(self.meta["seed"])

    # -- commitment groups --------------------------------------------------
    def points(self, tag: str, fn):
        """Memoize a list of affine points [(x, y) | None]."""
        hit = self.meta["points"].get(tag)
        if hit is not None:
            return [None if p is None else (int(p[0], 16), int(p[1], 16)) for p in hit]
        pts = fn()
        self.meta["points"][tag] = [None if p is None else [hex(p[0]), hex(p[1])] for p in pts]
        self._flush()
        return pts

    def has_points(self, tag: str) -> bool:
        return tag in self.meta["points"]

    # -- scalar lists -------------------------------------------------------
    def scalars(self, tag: str, fn):
        hit = self.meta["scalars"].get(tag)
        if hit is not None:
            return [int(v, 16) for v in hit]
        vals = fn()
        self.meta["scalars"][tag] = [hex(int(v)) for v in vals]
        self._flush()
        return vals

    # -- per-lookup host columns -------------------------------------------
    def lookup(self, li: int, fn):
        """Memoize {'a','s','a_perm','s_perm'} packed u32 arrays."""
        path = os.path.join(self.dir, f"lookup_{li}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return {k: z[k] for k in ("a", "s", "a_perm", "s_perm")}
        entry = fn()
        tmp = path + ".tmp.npz"
        np.savez(tmp, **{k: entry[k] for k in ("a", "s", "a_perm", "s_perm")})
        os.replace(tmp, path)
        return entry

    def has_lookup(self, li: int) -> bool:
        return os.path.exists(os.path.join(self.dir, f"lookup_{li}.npz"))

    # -- quotient coset accumulators ---------------------------------------
    def coset(self, r: int, fn):
        """Memoize one packed (n, 8) u32 quotient accumulator."""
        path = os.path.join(self.dir, f"coset_{r}.npy")
        if os.path.exists(path):
            return np.load(path)
        arr = fn()
        tmp = path + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, path)
        return arr

    def has_coset(self, r: int) -> bool:
        return os.path.exists(os.path.join(self.dir, f"coset_{r}.npy"))
