"""EVM verifier contract: the assembler (`Asm`), the constructor that
deploys a runtime (`gen_deployment`), and a pairing-only runtime that
performs the final KZG pairing check via the 0x08 precompile.

The pairing-only contract leaves the transcript to the host, which folds
the multiopen into two G1 points (plonk/verifier.py `pairing_inputs`
mode); the contract checks e(A, s*G2) * e(-B, G2) == 1 with the G2
constants baked in at generation time — the same tail the reference's YUL
verifier executes with hard-coded G2/s-G2 (SURVEY.md section 2.4).
full_verifier.py recomputes the whole transcript in bytecode on this
module's assembler and constructor.

Calldata: A.x || A.y || B.x || B.y (4 x 32B big-endian words).
"""
from __future__ import annotations

from ..fields.bn254 import FQ_MOD


class Asm:
    def __init__(self):
        self.code = bytearray()

    def push(self, v: int) -> "Asm":
        b = v.to_bytes(max((v.bit_length() + 7) // 8, 1), "big")
        self.code.append(0x5F + len(b))
        self.code += b
        return self

    def op(self, *ops: int) -> "Asm":
        self.code += bytes(ops)
        return self

    def raw(self, b: bytes) -> "Asm":
        self.code += b
        return self


MSTORE, MLOAD, CALLDATALOAD, STATICCALL = 0x52, 0x51, 0x35, 0xFA
SUB, EQ, ISZERO, JUMPI, JUMPDEST, RETURN, REVERT, GAS = (
    0x03, 0x14, 0x15, 0x57, 0x5B, 0xF3, 0xFD, 0x5A,
)
DUP1, SWAP1, POP, CODECOPY, PUSH0 = 0x80, 0x90, 0x50, 0x39, 0x5F


def _store_word(a: Asm, mem_off: int, value: int):
    a.push(value).push(mem_off).op(MSTORE)


def _store_calldata_word(a: Asm, mem_off: int, cd_off: int):
    a.push(cd_off).op(CALLDATALOAD).push(mem_off).op(MSTORE)


def gen_runtime(g2, s_g2) -> bytes:
    """Runtime code for the pairing-check verifier."""
    a = Asm()
    # pairing input layout in memory (384 bytes):
    #   0x000 A.x   0x020 A.y   0x040..0x0a0 G2s (s*G2)
    #   0x180 B.x   0x1a0 (p - B.y)   0x1c0..0x220 G2
    _store_calldata_word(a, 0x000, 0x00)
    _store_calldata_word(a, 0x020, 0x20)
    (sx0, sx1), (sy0, sy1) = s_g2
    # EVM G2 encoding: x_im, x_re, y_im, y_re
    _store_word(a, 0x040, sx1)
    _store_word(a, 0x060, sx0)
    _store_word(a, 0x080, sy1)
    _store_word(a, 0x0A0, sy0)
    _store_calldata_word(a, 0x0C0, 0x40)
    # negate B.y: p - y (y == 0 handled: p - 0 = p, but identity B means the
    # pair is degenerate; the precompile treats (0, p) as invalid -> revert,
    # which is the safe failure mode)
    a.push(0x60).op(CALLDATALOAD)          # y
    a.push(FQ_MOD).op(SUB)                 # p - y
    a.push(0x0E0).op(MSTORE)
    (gx0, gx1), (gy0, gy1) = g2
    _store_word(a, 0x100, gx1)
    _store_word(a, 0x120, gx0)
    _store_word(a, 0x140, gy1)
    _store_word(a, 0x160, gy0)
    # staticcall(gas, 0x08, 0, 0x180, 0x180, 0x20)
    a.push(0x20).push(0x180).push(0x180).push(0)
    a.push(8).op(GAS).op(STATICCALL)
    # success && mload(0x180) == 1
    a.push(0x180).op(MLOAD).op(0x16)  # AND(success, result)
    a.push(1).op(EQ)
    # jump to success dest if ok
    ok_dest_placeholder = len(a.code) + 1
    a.push(0xFFFF)  # patched below (2-byte push)
    a.op(JUMPI)
    a.push(0).push(0).op(REVERT)
    ok = len(a.code)
    a.op(JUMPDEST)
    a.push(0).push(0).op(RETURN)
    # patch jump destination
    a.code[ok_dest_placeholder : ok_dest_placeholder + 2] = ok.to_bytes(2, "big")
    return bytes(a.code)


def gen_deployment(runtime: bytes) -> bytes:
    """Constructor: codecopy runtime to memory, return it."""
    a = Asm()
    # codecopy(0, <offset>, len); return(0, len)
    # offset = len(constructor); compute with a two-pass assemble
    for offset_guess in range(8, 64):
        a = Asm()
        a.push(len(runtime)).push(offset_guess).push(0).op(CODECOPY)
        a.push(len(runtime)).push(0).op(RETURN)
        if len(a.code) == offset_guess:
            return bytes(a.code) + runtime
    raise AssertionError("constructor assembly did not converge")


def gen_verifier_bytecode(g2, s_g2) -> bytes:
    """Full deployment bytecode (constructor || runtime)."""
    return gen_deployment(gen_runtime(g2, s_g2))
