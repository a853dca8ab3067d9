"""Batched Poseidon permutation over Fr limb planes (the JAX package's
ops/poseidon_dev.py).

The host Poseidon (hashes/poseidon.py) serves transcripts, one state at a
time; witness generation hashes many trie nodes or code chunks at once,
which is this module's job. The 65 rounds run as a Python loop over
(n, 3, 16) Montgomery states: add the round constants, the x^5 S-box (three
Montgomery products, K1 on the card) on all three lanes in a full round and
on lane 0 in a partial one, then the 3 x 3 MDS as nine products.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fields.bn254 import FR_MOD
from ..fields.limbs import FR_LIMB, ints_to_limbs, limbs_from_torch, limbs_to_torch
from ..hashes.poseidon import poseidon_fr
from . import field_ops as fo

F = FR_LIMB


def _mont(vals) -> np.ndarray:
    return ints_to_limbs([int(v) * (1 << 256) % FR_MOD for v in vals])


class PoseidonDev:
    """Batched t = 3 Poseidon permutation on `device`."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        h = poseidon_fr
        self.h = h
        rounds = h.r_f + h.r_p
        self.rc = limbs_to_torch(np.stack([_mont(h.rc[r]) for r in range(rounds)]), self.device)  # (rounds, 3, 16)
        self.mds = limbs_to_torch(np.stack([_mont(row) for row in h.mds]), self.device)  # (3, 3, 16)
        half = h.r_f // 2
        self.full = [True] * half + [False] * h.r_p + [True] * half

    def _sbox(self, x):
        x2 = fo.mont_mul(F, x, x)
        x4 = fo.mont_mul(F, x2, x2)
        return fo.mont_mul(F, x4, x)

    def _permute(self, state):
        """state: (n, 3, 16) Montgomery -> (n, 3, 16)."""
        mds = self.mds
        for rc, full in zip(self.rc, self.full):
            s = fo.add_mod(F, state, rc.expand_as(state))
            if full:
                keep = self._sbox(s)
            else:
                keep = torch.cat([self._sbox(s[:, :1]), s[:, 1:]], dim=1)
            outs = []
            for i in range(3):
                acc = fo.mont_mul(F, mds[i, 0], keep[:, 0])
                for j in (1, 2):
                    acc = fo.add_mod(F, acc, fo.mont_mul(F, mds[i, j], keep[:, j]))
                outs.append(acc)
            state = torch.stack(outs, dim=1)
        return state

    def hash2_batch(self, a_vals: list[int], b_vals: list[int], domain: int = 0) -> list[int]:
        """Batched hash2: permute([a, b, domain])[0] per row; host int io."""
        n = len(a_vals)
        state = np.stack([_mont(a_vals), _mont(b_vals), _mont([domain] * n)], axis=1)  # (n, 3, 16)
        out = self._permute(limbs_to_torch(state, self.device))
        return F.decode(limbs_from_torch(out[:, 0]))
