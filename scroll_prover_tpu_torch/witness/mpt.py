"""Storage-MPT witness: a path-compressed Poseidon-SMT over the chunk's
final storage state, with one inclusion proof per accessed (addr, slot).

This is the witness side of the MPT subcircuit (reference scope:
halo2-mpt-circuits + the mpt-zktrie adapter, SURVEY.md section 2.2). The
state-key/value schedule mirrors Scroll's zktrie shape with this
framework's Poseidon:

    key        = poseidon(addr, poseidon(slot_hi, slot_lo, dom=2), dom=2)
    value_hash = poseidon(value_hi, value_lo, dom=3)
    leaf       = poseidon(key, value_hash, dom=1)     (trie/zktrie.py)

Each derivation step is ONE Poseidon permutation, so the MPT subcircuit
re-derives all of them fully constrained and chains the inclusion path to
a shared root.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..hashes.poseidon import poseidon_fr
from ..trie import PyZkTrie, verify_merkle_proof
from .block import TAG_STORAGE, WitnessBlock

_MASK128 = (1 << 128) - 1

DOM_KEY = 2
DOM_VALUE = 3


@dataclass
class MptEvent:
    addr: int
    slot: int
    value: int
    key: int
    value_hash: int
    siblings: list[int]  # root-side first; leaf depth == len(siblings)


def storage_mpt_witness(
    wb: WitnessBlock, cap: int | None = None
) -> tuple[int, list[MptEvent]]:
    """(root, events): builds the storage trie from the FINAL value of
    every storage slot the chunk touched and proves inclusion for the
    first `cap` of them (cap = in-circuit verification capacity; the
    trie itself always holds every slot)."""
    final: dict[tuple[int, int], int] = {}
    for r in sorted(wb.rw_rows, key=lambda r: r.rwc):
        if r.tag == TAG_STORAGE:
            final[(r.addr, r.key)] = r.value
    trie = PyZkTrie()
    recs = []
    for (addr, slot), val in sorted(final.items()):
        s_hi, s_lo = slot >> 128, slot & _MASK128
        v_hi, v_lo = val >> 128, val & _MASK128
        key = poseidon_fr.hash2(
            addr, poseidon_fr.hash2(s_hi, s_lo, domain=DOM_KEY), domain=DOM_KEY
        )
        vh = poseidon_fr.hash2(v_hi, v_lo, domain=DOM_VALUE)
        trie.update(key, vh)
        recs.append((addr, slot, val, key, vh))
    root = trie.root()
    events = []
    for addr, slot, val, key, vh in recs[: cap if cap is not None else len(recs)]:
        sib = trie.prove(key)
        assert verify_merkle_proof(root, key, vh, sib)
        events.append(MptEvent(addr, slot, val, key, vh, sib))
    return root, events
