"""Elliptic-curve layer: host-side BN254 G1/G2/pairing + device entry points.

Host side replaces the verify-time surface of the reference's halo2curves
fork (SURVEY.md L0: "BN254 Fq/Fr ... G1/G2, pairings (verify-side)"); the
device (MSM) side lives in ops/ec.py + ops/msm.py.
"""
from .bn254_curve import G1, G2, g1_generator, g2_generator  # noqa: F401
from .pairing import pairing_check  # noqa: F401
