"""The reference's sums, split over index ranges so that a pool of worker
processes shares them. Every check of benchref.checks is one or two of
these sums over a sample's columns:

    powers:  sum_j v_j x^j          (v_j = a_j, a_j b_j or a_j / b_j)
    lagrange: sum_i v_i L_i(z)      over the n-th roots of unity, for
                                    several columns of one (n, z) at once
    geometric: whether b_{j+1} b_1 == b_j b_0 for every j

Columns travel as raw (m, 16) limb arrays and are decoded in the worker.
"""
from __future__ import annotations

from .field import R, batch_inverse, horner, limbs_to_ints, omega


def _powers(x, lo, a, b, mode):
    va = limbs_to_ints(a)
    if mode == "mul":
        va = [p * q % R for p, q in zip(va, limbs_to_ints(b))]
    elif mode == "div":
        va = [p * q % R for p, q in zip(va, batch_inverse(limbs_to_ints(b)))]
    return horner(va, x) * pow(x, lo, R) % R


def _lagrange(z, n, lo, columns):
    """sum over i in [lo, lo + m) of v_i omega^i / (z - omega^i), per column;
    the caller multiplies by (z^n - 1) / n."""
    w = omega(n)
    m = len(columns[0])
    pts = [pow(w, lo, R)] * m
    for i in range(1, m):
        pts[i] = pts[i - 1] * w % R
    inv = batch_inverse([(z - p) % R for p in pts])
    ws = [p * q % R for p, q in zip(pts, inv)]
    return [sum(a * b for a, b in zip(limbs_to_ints(col), ws)) % R for col in columns]


def _geometric(b):
    """Whether every ratio b_{j+1} / b_j of the slice equals its first."""
    v = limbs_to_ints(b)
    return all(q * v[0] % R == p * v[1] % R for p, q in zip(v, v[1:]))


def work(job):
    """One range of one sum (a pool's task)."""
    op = job[0]
    if op == "powers":
        return _powers(*job[1:])
    if op == "lagrange":
        return _lagrange(*job[1:])
    if op == "geometric":
        return _geometric(job[1])
    raise ValueError(op)


def ranges(n: int, parts: int):
    step = max(1 << 12, -(-n // parts))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


class Sums:
    """Collects the sums of many checks, runs them (in `pool`, or here), and
    hands back each sum whole."""

    def __init__(self, parts: int):
        self.parts = parts
        self.jobs = []
        self.slots = []  # per sum: ("add" | "all" | "lagrange", job indices[, column index])
        self._lagrange = {}  # (n, z) -> [columns, [(slot, column index)]]

    def powers(self, x: int, a, b=None, mode: str | None = None) -> int:
        idx = []
        for lo, hi in ranges(len(a), self.parts):
            idx.append(len(self.jobs))
            self.jobs.append(("powers", x, lo, a[lo:hi], None if b is None else b[lo:hi], mode))
        self.slots.append(("add", idx))
        return len(self.slots) - 1

    def geometric(self, b) -> int:
        idx = []
        for lo, hi in ranges(len(b), self.parts):
            idx.append(len(self.jobs))
            # one pair of overlap: neighbouring ranges share a ratio
            self.jobs.append(("geometric", b[lo:min(len(b), hi + 2)]))
        self.slots.append(("all", idx))
        return len(self.slots) - 1

    def lagrange(self, z: int, n: int, a) -> int:
        """sum_i a_i L_i(z), a of length <= n (the rest taken as 0)."""
        entry = self._lagrange.setdefault((n, z), [[], []])
        self.slots.append(("lagrange", (n, z), len(entry[0])))
        entry[0].append(a)
        return len(self.slots) - 1

    def run(self, pool=None) -> list:
        lag_jobs = {}
        for (n, z), (cols, _) in self._lagrange.items():
            top = max(len(c) for c in cols)
            lag_jobs[(n, z)] = []
            for lo, hi in ranges(top, self.parts):
                part = [c[lo:hi] if lo < len(c) else c[:0] for c in cols]
                width = hi - lo
                # pad the shorter columns' slices with zero rows
                part = [p if len(p) == width else _pad(p, width) for p in part]
                lag_jobs[(n, z)].append(len(self.jobs))
                self.jobs.append(("lagrange", z, n, lo, part))
        results = (pool.map(work, self.jobs, chunksize=1) if pool is not None else [work(j) for j in self.jobs])
        out = []
        for slot in self.slots:
            if slot[0] == "add":
                out.append(sum(results[i] for i in slot[1]) % R)
            elif slot[0] == "all":
                out.append(all(results[i] for i in slot[1]))
            else:
                n, z = slot[1]
                factor = (pow(z, n, R) - 1) * pow(n, -1, R) % R
                out.append(sum(results[i][slot[2]] for i in lag_jobs[(n, z)]) * factor % R)
        return out


def _pad(arr, width):
    import numpy as np

    out = np.zeros((width,) + arr.shape[1:], dtype=arr.dtype)
    out[:len(arr)] = arr
    return out
