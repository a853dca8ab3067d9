"""Proof-system layer: transcripts, KZG commitment scheme, PLONKish backend."""
from .transcript import PoseidonTranscript, KeccakTranscript, Blake2bTranscript  # noqa: F401
from .kzg import SRS, kzg_commit, kzg_open, srs_from_numpy, verify_single_open  # noqa: F401
