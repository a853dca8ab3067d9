"""PLONKish proving backend (halo2-shaped), in PyTorch.

Split, as in the JAX package:
  expression.py  — gate expression AST, evaluated by caller-supplied ops
  cs.py          — ConstraintSystem + circuit/assignment model (and the
                   assignment disk cache, assign_cached)
  mock.py        — MockProver equivalent (constraint checker, no proving)
  keygen.py      — vk/pk: fixed/sigma polys + commitments
  prover.py      — the prover (device NTT/MSM/scans, host orchestration;
                   the low-memory path under SPT_LOWMEM)
  checkpoint.py  — ProveCheckpoint: phase checkpoint/resume on disk
  multiopen.py   — SHPLONK multiopen (GWC lives in prover/verifier)
  verifier.py    — host verifier (pairing check)
"""
from .expression import (  # noqa: F401
    Advice, Challenge, Constant, Expression, Fixed, Instance,
)
from .cs import Circuit, ConstraintSystem  # noqa: F401
from .mock import MockProver  # noqa: F401
