"""Full in-bytecode PLONK verifier generator (the snark-verifier EVM-loader
role): straight-line EVM bytecode + matching YUL source that recompute the
ENTIRE Keccak Fiat-Shamir transcript, all scalar verification arithmetic,
and the GWC multiopen fold from calldata alone, ending in one pairing
precompile call — no host verifier in the loop (reference
release-v0.13.1/evm_verifier.yul recomputes the same pipeline with
hard-coded vk commitments and G2 constants).

The runtime is assembled directly and the YUL text is emitted as the
auditable source artifact; no solc step runs (the reference goes YUL ->
solc 0.8.19 -> bin). Calldata layout follows the reference:
[instance words (the first 12 being the KZG accumulator limbs when the
circuit carries one) || proof], all 32-byte words big-endian
(BundleProof.calldata re-encodes the little-endian wire proof).

Mirror discipline: this generator walks proof_system/plonk/verifier.py
statement-for-statement with KeccakTranscript semantics; the codegen
callbacks of Expression.evaluate emit the gate arithmetic.

The quotient piece count and the permutation chunking come from the
port's prover (`_n_h`, `_perm_chunks`), whose degree budget counts
lookups. Where the floor of 5 governs (every layer circuit of the ladder,
and circuits whose lookups fit the gate budget) the bytecode is byte for
byte the reference generator's. Where a lookup sets a higher budget (the
super circuit) the bytecode follows the port's budget: it verifies the
port's proofs, whose quotient has the pieces that budget gives.
"""
from __future__ import annotations

from ..curves.bn254_curve import g1_generator
from ..fields.bn254 import FQ_MOD, FR_MOD
from ..proof_system.plonk.keygen import DELTA, VerifyingKey
from ..proof_system.plonk.prover import _n_h, _Queries, _perm_chunks
from .verifier_contract import Asm, gen_deployment

# opcodes
MSTORE, MLOAD, CALLDATALOAD, CALLDATACOPY = 0x52, 0x51, 0x35, 0x37
ADD, MUL, SUB, DIV, MOD, ADDMOD, MULMOD, EXP = 0x01, 0x02, 0x03, 0x04, 0x06, 0x08, 0x09, 0x0A
LT, GT, EQ, ISZERO, AND, OR, NOT = 0x10, 0x11, 0x14, 0x15, 0x16, 0x17, 0x19
SHA3, GAS, STATICCALL, JUMP, JUMPI, JUMPDEST = 0x20, 0x5A, 0xFA, 0x56, 0x57, 0x5B
RETURN, REVERT, POP, DUP1, SWAP1 = 0xF3, 0xFD, 0x50, 0x80, 0x90

# memory map
SCRATCH = 0x0000  # 0x200 bytes: precompile IO
TBUF = 0x0400    # transcript buffer (len tracked statically; max ~16 KB)
SLOTS = 0x8000   # value slots, 32 B each

_REVERT_DEST = 4  # PUSH2 <start> JUMP; JUMPDEST; PUSH0 PUSH0 REVERT


class Gen:
    """Straight-line bytecode emitter with a parallel YUL rendering.

    debug=True replaces the shared silent revert target with a tagged one:
    every check site pushes a unique tag before the JUMPI, and the revert
    returns the tag as 32-byte revert data (self.tags maps tag -> label)."""

    def __init__(self, debug: bool = False):
        self.a = Asm()
        self.yul: list[str] = []
        self._slot = SLOTS
        self.tlen = 0  # transcript buffer length (static)
        self.debug = debug
        self.tags: dict[int, str] = {}
        # preamble: jump over the shared revert target
        self.a.op(0x61, 0x00, 0x00, JUMP)  # PUSH2 start(patched) JUMP
        self.a.op(JUMPDEST)                # offset 4: revert target
        if debug:
            # stack: [tag]; revert(0, 32) with tag stored at mem[0]
            self.a.op(0x5F, MSTORE)        # mstore(0, tag)
            self.a.op(0x60, 0x20, 0x5F, REVERT)  # revert(0, 32)
        else:
            self.a.op(0x5F, 0x5F, REVERT)  # PUSH0 PUSH0 REVERT
        start = len(self.a.code)
        self.a.code[1:3] = start.to_bytes(2, "big")
        self.a.op(JUMPDEST)
        self.yul.append("object \"plonk_verifier\" { code {")

    def jumpi_revert(self, label: str = ""):
        """Emit `JUMPI -> revert` consuming the condition on top of stack."""
        if self.debug:
            tag = len(self.tags) + 1
            self.tags[tag] = label
            self.a.push(tag)   # [cond, tag]
            self.a.op(SWAP1)   # [tag, cond]
            self._push(_REVERT_DEST)
            self.a.op(JUMPI)   # leaves [tag] when not taken
            self.a.op(POP)
        else:
            self._push(_REVERT_DEST)
            self.a.op(JUMPI)

    # -- slots -------------------------------------------------------------

    def slot(self) -> int:
        s = self._slot
        self._slot += 32
        return s

    def _push(self, v: int):
        if v == 0:
            self.a.op(0x5F)
        else:
            self.a.push(int(v))

    def const(self, v: int) -> int:
        s = self.slot()
        self._push(v % FR_MOD)
        self._push(s)
        self.a.op(MSTORE)
        self.yul.append(f"  mstore({s:#x}, {v % FR_MOD:#x})")
        return s

    def cd_word(self, off: int) -> int:
        """calldata word -> fresh slot (no range check)."""
        s = self.slot()
        self._push(off)
        self.a.op(CALLDATALOAD)
        self._push(s)
        self.a.op(MSTORE)
        self.yul.append(f"  mstore({s:#x}, calldataload({off:#x}))")
        return s

    def require_lt(self, s: int, bound: int):
        """revert unless mem[s] < bound."""
        self._push(bound)
        self._push(s)
        self.a.op(MLOAD)
        self.a.op(LT)         # mload(s) < bound
        self.a.op(ISZERO)
        self.jumpi_revert(f"require_lt slot {s:#x}")
        self.yul.append(
            f"  if iszero(lt(mload({s:#x}), {bound:#x})) {{ revert(0, 0) }}"
        )

    # -- Fr arithmetic (values in slots) -----------------------------------

    def _binmod(self, opc: int, name: str, x: int, y: int, m: int = FR_MOD) -> int:
        out = self.slot()
        self._push(m)
        self._push(y)
        self.a.op(MLOAD)
        self._push(x)
        self.a.op(MLOAD)
        self.a.op(opc)
        self._push(out)
        self.a.op(MSTORE)
        self.yul.append(
            f"  mstore({out:#x}, {name}(mload({x:#x}), mload({y:#x}), {m:#x}))"
        )
        return out

    def addf(self, x: int, y: int) -> int:
        return self._binmod(ADDMOD, "addmod", x, y)

    def mulf(self, x: int, y: int) -> int:
        return self._binmod(MULMOD, "mulmod", x, y)

    def subf(self, x: int, y: int) -> int:
        ny = self.mulc(y, FR_MOD - 1)
        return self.addf(x, ny)

    def addc(self, x: int, c: int) -> int:
        return self.addf(x, self.const(c))

    def mulc(self, x: int, c: int) -> int:
        return self.mulf(x, self.const(c))

    def invf(self, x: int) -> int:
        """Fermat inverse via the modexp precompile (0x05)."""
        # input at SCRATCH: 32,32,32, base, exp=r-2, mod=r
        for off, v in ((0, 32), (32, 32), (64, 32)):
            self._push(v)
            self._push(SCRATCH + off)
            self.a.op(MSTORE)
        self._push(x)
        self.a.op(MLOAD)
        self._push(SCRATCH + 96)
        self.a.op(MSTORE)
        self._push(FR_MOD - 2)
        self._push(SCRATCH + 128)
        self.a.op(MSTORE)
        self._push(FR_MOD)
        self._push(SCRATCH + 160)
        self.a.op(MSTORE)
        out = self.slot()
        # staticcall(gas, 5, in=SCRATCH, 192, out, 32)
        self._push(32)
        self._push(out)
        self._push(192)
        self._push(SCRATCH)
        self._push(5)
        self.a.op(GAS, STATICCALL)
        self.a.op(ISZERO)
        self.jumpi_revert("modexp staticcall")
        self.yul.append(
            f"  // mstore({out:#x}, modexp(mload({x:#x}), r-2, r))\n"
            f"  mstore(0x00, 32) mstore(0x20, 32) mstore(0x40, 32)\n"
            f"  mstore(0x60, mload({x:#x})) mstore(0x80, {FR_MOD - 2:#x})\n"
            f"  mstore(0xa0, {FR_MOD:#x})\n"
            f"  if iszero(staticcall(gas(), 5, 0, 192, {out:#x}, 32)) "
            "{ revert(0, 0) }"
        )
        return out

    # -- EC points (64 B: x then y, both in memory) ------------------------

    def point_slot(self) -> int:
        s = self._slot
        self._slot += 64
        return s

    def cd_point(self, off: int) -> int:
        """Read (x, y) from calldata with an on-curve check. The identity
        encoding (0, 0) is ACCEPTED — prover h-chunk commitments can be the
        zero polynomial (quotient degree below the n_h worst case), and the
        EVM ecAdd/ecMul precompiles natively treat (0,0) as identity."""
        p = self.point_slot()
        for i in (0, 32):
            self._push(off + i)
            self.a.op(CALLDATALOAD)
            self._push(p + i)
            self.a.op(MSTORE)
        self.yul.append(
            f"  mstore({p:#x}, calldataload({off:#x})) "
            f"mstore({p + 32:#x}, calldataload({off + 32:#x}))"
        )
        self._on_curve(p)
        return p

    def _on_curve(self, p: int):
        """require (x,y) == (0,0)  OR  y^2 % q == (x^3 + 3) % q."""
        q = FQ_MOD
        # stack discipline: [yy, q, 3, q, q, x, x] -> mulmod -> ... -> EQ
        self._push(q)
        self._push(p + 32)
        self.a.op(MLOAD)
        self.a.op(DUP1)
        self.a.op(MULMOD)  # [yy]
        self._push(q)      # [yy, q]
        self._push(3)      # [yy, q, 3]
        self._push(q)
        self._push(q)      # [yy, q, 3, q, q]
        self._push(p)
        self.a.op(MLOAD)
        self.a.op(DUP1)    # [yy, q, 3, q, q, x, x]
        self.a.op(MULMOD)  # [yy, q, 3, q, xx]
        self._push(p)
        self.a.op(MLOAD)   # [yy, q, 3, q, xx, x]
        self.a.op(MULMOD)  # [yy, q, 3, x3]
        self.a.op(ADDMOD)  # [yy, (x3+3)%q]
        self.a.op(EQ)      # [on_curve]
        # identity: iszero(x | y)
        self._push(p)
        self.a.op(MLOAD)
        self._push(p + 32)
        self.a.op(MLOAD)
        self.a.op(OR, ISZERO)  # [on_curve, is_identity]
        self.a.op(OR, ISZERO)  # [!(on_curve || identity)]
        self.jumpi_revert(f"on_curve point {p:#x}")
        x, y = f"mload({p:#x})", f"mload({p + 32:#x})"
        self.yul.append(
            f"  if iszero(or(eq(mulmod({y}, {y}, {q:#x}), "
            f"addmod(mulmod(mulmod({x}, {x}, {q:#x}), {x}, {q:#x}), 3, {q:#x})), "
            f"iszero(or({x}, {y}))))"
            " { revert(0, 0) }"
        )

    def const_point(self, pt) -> int:
        p = self.point_slot()
        for i, v in enumerate(pt):
            self._push(v)
            self._push(p + 32 * i)
            self.a.op(MSTORE)
        self.yul.append(
            f"  mstore({p:#x}, {pt[0]:#x}) mstore({p + 32:#x}, {pt[1]:#x})"
        )
        return p

    def _ec_call(self, addr: int, in_off: int, in_len: int, out_off: int):
        self._push(64)
        self._push(out_off)
        self._push(in_len)
        self._push(in_off)
        self._push(addr)
        self.a.op(GAS, STATICCALL)
        self.a.op(ISZERO)
        self.jumpi_revert(f"ec precompile {addr}")

    def ec_mul(self, p: int, s: int) -> int:
        """[s]P via precompile 0x07; scalar slot s, point slot p."""
        out = self.point_slot()
        for i in (0, 32):
            self._push(p + i)
            self.a.op(MLOAD)
            self._push(SCRATCH + i)
            self.a.op(MSTORE)
        self._push(s)
        self.a.op(MLOAD)
        self._push(SCRATCH + 64)
        self.a.op(MSTORE)
        self._ec_call(7, SCRATCH, 96, out)
        self.yul.append(
            f"  // {out:#x} := ecMul({p:#x}, mload({s:#x}))\n"
            f"  mstore(0x00, mload({p:#x})) mstore(0x20, mload({p + 32:#x})) "
            f"mstore(0x40, mload({s:#x}))\n"
            f"  if iszero(staticcall(gas(), 7, 0, 96, {out:#x}, 64)) "
            "{ revert(0, 0) }"
        )
        return out

    def ec_add(self, p: int, q: int) -> int:
        out = self.point_slot()
        for src, dst in ((p, 0), (q, 64)):
            for i in (0, 32):
                self._push(src + i)
                self.a.op(MLOAD)
                self._push(SCRATCH + dst + i)
                self.a.op(MSTORE)
        self._ec_call(6, SCRATCH, 128, out)
        self.yul.append(
            f"  // {out:#x} := ecAdd({p:#x}, {q:#x})\n"
            f"  mstore(0x00, mload({p:#x})) mstore(0x20, mload({p + 32:#x})) "
            f"mstore(0x40, mload({q:#x})) mstore(0x60, mload({q + 32:#x}))\n"
            f"  if iszero(staticcall(gas(), 6, 0, 128, {out:#x}, 64)) "
            "{ revert(0, 0) }"
        )
        return out

    def ec_neg(self, p: int) -> int:
        """(x, (q - y) % q); the mod keeps the identity encoding (0, 0)
        valid (q - 0 = q would be an out-of-range coordinate)."""
        out = self.point_slot()
        self._push(p)
        self.a.op(MLOAD)
        self._push(out)
        self.a.op(MSTORE)
        self._push(FQ_MOD)
        self._push(p + 32)
        self.a.op(MLOAD)
        self._push(FQ_MOD)
        self.a.op(SUB, MOD)
        self._push(out + 32)
        self.a.op(MSTORE)
        self.yul.append(
            f"  mstore({out:#x}, mload({p:#x})) "
            f"mstore({out + 32:#x}, mod(sub({FQ_MOD:#x}, mload({p + 32:#x})), "
            f"{FQ_MOD:#x}))"
        )
        return out

    # -- transcript (KeccakTranscript mirror) ------------------------------

    def absorb_const(self, v: int):
        self._push(v)
        self._push(TBUF + self.tlen)
        self.a.op(MSTORE)
        self.yul.append(f"  mstore({TBUF + self.tlen:#x}, {v:#x})")
        self.tlen += 32

    def absorb_slot(self, s: int):
        self._push(s)
        self.a.op(MLOAD)
        self._push(TBUF + self.tlen)
        self.a.op(MSTORE)
        self.yul.append(f"  mstore({TBUF + self.tlen:#x}, mload({s:#x}))")
        self.tlen += 32

    def absorb_point(self, p: int):
        self.absorb_slot(p)
        self.absorb_slot(p + 32)

    def squeeze(self) -> int:
        """challenge = keccak(buf) % r; state resets to the raw digest."""
        c = self.slot()
        self._push(self.tlen)  # [size]
        self._push(TBUF)       # [size, offset]
        self.a.op(SHA3)        # [d]
        self.a.op(DUP1)        # [d, d]
        self._push(TBUF)
        self.a.op(MSTORE)      # state := digest; [d]
        self._push(FR_MOD)     # [d, r]
        self.a.op(SWAP1)       # [r, d]
        self.a.op(MOD)         # [d % r]
        self._push(c)
        self.a.op(MSTORE)
        self.yul.append(
            f"  {{ let d := keccak256({TBUF:#x}, {self.tlen:#x}) "
            f"mstore({TBUF:#x}, d) mstore({c:#x}, mod(d, {FR_MOD:#x})) }}"
        )
        self.tlen = 32
        return c

    # -- finish ------------------------------------------------------------

    def pairing_check(self, lhs: int, rhs: int, g2, s_g2):
        """e(lhs, s_g2) * e(-rhs, g2) == 1 via precompile 0x08; return
        empty on success, revert otherwise (reference YUL tail)."""
        neg = self.ec_neg(rhs)
        base = SCRATCH
        layout = [
            (lhs, None), (None, s_g2), (neg, None), (None, g2),
        ]
        off = base
        for pslot, g2pt in layout:
            if pslot is not None:
                for i in (0, 32):
                    self._push(pslot + i)
                    self.a.op(MLOAD)
                    self._push(off)
                    self.a.op(MSTORE)
                    self.yul.append(f"  mstore({off:#x}, mload({pslot + i:#x}))")
                    off += 32
            else:
                (x0, x1), (y0, y1) = g2pt
                for v in (x1, x0, y1, y0):  # EVM G2 encoding: imag first
                    self._push(v)
                    self._push(off)
                    self.a.op(MSTORE)
                    self.yul.append(f"  mstore({off:#x}, {v:#x})")
                    off += 32
        out = self.slot()
        self._push(32)
        self._push(out)
        self._push(off - base)
        self._push(base)
        self._push(8)
        self.a.op(GAS, STATICCALL)
        self._push(out)
        self.a.op(MLOAD)
        self.a.op(AND)  # success && result
        self.a.op(ISZERO)
        self.jumpi_revert("final pairing")
        self._push(0)
        self._push(0)
        self.a.op(RETURN)
        self.yul.append(
            f"  if iszero(and(staticcall(gas(), 8, {base:#x}, {off - base:#x},"
            f" {out:#x}, 32), mload({out:#x}))) {{ revert(0, 0) }}\n"
            "  return(0, 0)\n}}"
        )

    def finish(self) -> tuple[bytes, str]:
        return bytes(self.a.code), "\n".join(self.yul)


def gen_full_verifier(
    vk: VerifyingKey, srs, num_instance: int, has_accumulator: bool = False,
    debug: bool = False, _gen_out: list | None = None,
) -> tuple[bytes, str]:
    """(deployment_bytecode, yul_source) for a full in-bytecode verifier of
    proofs under `vk` with the Keccak transcript. Calldata:
    [num_instance x 32B instance words || proof words (BE)]."""
    g = Gen(debug=debug)
    if _gen_out is not None:
        _gen_out.append(g)
    cs = vk.cs
    dom = vk.domain
    n = dom.n
    usable = cs.usable_rows(n)
    u_row = usable - 1
    omega = dom.omega
    m = len(cs.perm_columns)
    chunk_len = _perm_chunks(cs)
    chunks = [
        list(range(a, min(a + chunk_len, m))) for a in range(0, m, chunk_len)
    ]

    # instance cells from calldata (bound-checked < r)
    inst = []
    for i in range(num_instance):
        s = g.cd_word(32 * i)
        g.require_lt(s, FR_MOD)
        inst.append(s)
    proof_base = 32 * num_instance

    # transcript preamble (prover.absorb_instances with Keccak semantics)
    g.absorb_const(vk.transcript_repr())
    g.absorb_const(num_instance)
    for s in inst:
        g.absorb_slot(s)

    off = [proof_base]  # mutable proof cursor

    def read_point() -> int:
        p = g.cd_point(off[0])
        off[0] += 64
        g.absorb_point(p)
        return p

    def read_scalar() -> int:
        s = g.cd_word(off[0])
        off[0] += 32
        g.require_lt(s, FR_MOD)
        g.absorb_slot(s)
        return s

    advice_coms = [read_point() for _ in range(cs.num_advice)]
    theta = g.squeeze()
    lookup_coms = [(read_point(), read_point()) for _ in cs.lookups]
    beta = g.squeeze()
    gamma = g.squeeze()
    perm_z_coms = [read_point() for _ in chunks]
    lookup_z_coms = [read_point() for _ in cs.lookups]
    random_com = read_point()
    y_ch = g.squeeze()
    n_h = _n_h(cs, dom)
    h_coms = [read_point() for _ in range(n_h)]
    x = g.squeeze()

    omega_inv = pow(omega, -1, FR_MOD)
    rot_cells = {0: x}

    def rot_cell(rot: int) -> int:
        if rot not in rot_cells:
            c = pow(omega if rot >= 0 else omega_inv, abs(rot), FR_MOD)
            rot_cells[rot] = g.mulc(x, c)
        return rot_cells[rot]

    xw = rot_cell(1)

    qs = _Queries.from_cs(cs)
    queries = []  # (kind, handle, rot_id, value_slot)

    adv_evals = {}
    for col, rot in qs.advice:
        v = read_scalar()
        adv_evals[(col, rot)] = v
        queries.append((("w", advice_coms[col]), rot, v))
    fix_evals = {}
    for col, rot in qs.fixed:
        v = read_scalar()
        fix_evals[(col, rot)] = v
        queries.append((("c", vk.fixed_commitments[col]), rot, v))
    sigma_evals = []
    for j in range(m):
        v = read_scalar()
        sigma_evals.append(v)
        queries.append((("c", vk.sigma_commitments[j]), 0, v))
    perm_z_evals = []
    for a in range(len(chunks)):
        zx = read_scalar()
        zwx = read_scalar()
        queries.append((("w", perm_z_coms[a]), 0, zx))
        queries.append((("w", perm_z_coms[a]), 1, zwx))
        zu = None
        if a < len(chunks) - 1:
            zu = read_scalar()
            queries.append((("w", perm_z_coms[a]), "u", zu))
        perm_z_evals.append((zx, zwx, zu))
    lookup_evals = []
    for li in range(len(cs.lookups)):
        zx = read_scalar()
        zwx = read_scalar()
        ax = read_scalar()
        awi = read_scalar()
        sx = read_scalar()
        a_com, s_com = lookup_coms[li]
        queries.append((("w", lookup_z_coms[li]), 0, zx))
        queries.append((("w", lookup_z_coms[li]), 1, zwx))
        queries.append((("w", a_com), 0, ax))
        queries.append((("w", a_com), -1, awi))
        queries.append((("w", s_com), 0, sx))
        lookup_evals.append((zx, zwx, ax, awi, sx))
    random_eval = read_scalar()
    queries.append((("w", random_com), 0, random_eval))

    # --- scalar-side verification ------------------------------------
    one = g.const(1)
    xn = x
    for _ in range(vk.k):
        xn = g.mulf(xn, xn)
    vanish = g.addc(xn, FR_MOD - 1)
    vanish_inv = g.invf(vanish)

    n_inv_c = pow(n, -1, FR_MOD)
    lag_cache: dict[tuple[int, object], int] = {}

    def lagrange_at(i: int, rot_id) -> int:
        key = (i, rot_id)
        if key in lag_cache:
            return lag_cache[key]
        if rot_id == "u":
            z = rot_cell_u
        else:
            z = rot_cell(rot_id)
        wi = pow(omega, i, FR_MOD)
        num = g.mulc(g.addc(xn, FR_MOD - 1), wi)
        den = g.addc(g.mulc(z, n), (-n * wi) % FR_MOD)
        li = g.mulf(num, g.invf(den))
        lag_cache[key] = li
        return li

    rot_cell_u = g.mulc(x, pow(omega, u_row, FR_MOD))

    inst_cache: dict[tuple[int, int], int] = {}

    def inst_eval(col: int, rot: int) -> int:
        if (col, rot) in inst_cache:
            return inst_cache[(col, rot)]
        rid = rot if rot in (0, 1, -1) else rot
        acc = g.const(0)
        if col == 0:
            for i, s in enumerate(inst):
                acc = g.addf(acc, g.mulf(s, lagrange_at(i, rid)))
        inst_cache[(col, rot)] = acc
        return acc

    def qv(kind, col, rot):
        if kind == "advice":
            return adv_evals[(col, rot)]
        if kind == "fixed":
            return fix_evals[(col, rot)]
        return inst_eval(col, rot)

    l0_x = lagrange_at(0, 0)
    llast_x = lagrange_at(u_row, 0)
    lact = g.const(1)
    for i in range(u_row, n):
        lact = g.subf(lact, lagrange_at(i, 0))

    _ccache: dict[int, int] = {}

    def ccell(v: int) -> int:
        v %= FR_MOD
        if v not in _ccache:
            _ccache[v] = g.const(v)
        return _ccache[v]

    def eval_gate(expr) -> int:
        return expr.evaluate(
            constant=lambda c: ccell(c),
            query=qv,
            challenge=lambda i: theta,
            add=lambda p, q: g.addf(p, q),
            mul=lambda p, q: g.mulf(p, q),
            neg=lambda p: g.mulc(p, FR_MOD - 1),
        )

    terms = [eval_gate(e) for _, e in cs.gates]
    if chunks:
        z0x = perm_z_evals[0][0]
        terms.append(g.mulf(l0_x, g.subf(one, z0x)))
        zl = perm_z_evals[-1][0]
        terms.append(g.mulf(llast_x, g.subf(g.mulf(zl, zl), zl)))
        for a in range(1, len(chunks)):
            terms.append(
                g.mulf(l0_x, g.subf(perm_z_evals[a][0], perm_z_evals[a - 1][2]))
            )
        bx = g.mulf(beta, x)
        for a, chunk in enumerate(chunks):
            left = perm_z_evals[a][1]
            right = perm_z_evals[a][0]
            for jj in chunk:
                cref = cs.perm_columns[jj]
                v = qv(cref.kind, cref.index, 0)
                left = g.mulf(
                    left,
                    g.addf(g.addf(v, g.mulf(beta, sigma_evals[jj])), gamma),
                )
                right = g.mulf(
                    right,
                    g.addf(
                        g.addf(v, g.mulc(bx, pow(DELTA, jj, FR_MOD))), gamma
                    ),
                )
            terms.append(g.mulf(lact, g.subf(left, right)))
    for li, lk in enumerate(cs.lookups):
        zx, zwx, ax, awi, sx = lookup_evals[li]

        def compress(exprs):
            acc = None
            for e in exprs:
                ev = eval_gate(e)
                acc = ev if acc is None else g.addf(g.mulf(acc, theta), ev)
            return acc if acc is not None else ccell(0)

        in_x = compress(lk.inputs)
        tb_x = compress(lk.tables)
        terms.append(g.mulf(l0_x, g.subf(one, zx)))
        terms.append(g.mulf(llast_x, g.subf(g.mulf(zx, zx), zx)))
        lhs_t = g.mulf(g.mulf(zwx, g.addf(ax, beta)), g.addf(sx, gamma))
        rhs_t = g.mulf(g.mulf(zx, g.addf(in_x, beta)), g.addf(tb_x, gamma))
        terms.append(g.mulf(lact, g.subf(lhs_t, rhs_t)))
        terms.append(g.mulf(g.mulf(lact, g.subf(ax, sx)), g.subf(ax, awi)))
        terms.append(g.mulf(l0_x, g.subf(ax, sx)))

    acc_c = None
    for t in terms:
        acc_c = t if acc_c is None else g.addf(g.mulf(acc_c, y_ch), t)
    expected_h = g.mulf(acc_c, vanish_inv)

    # h_comb folded as extra x-group entries with xn^a coefficients
    queries.append((("h", tuple(h_coms)), 0, expected_h))

    v_ch = g.squeeze()

    points_order = []
    for _, rid, _ in queries:
        if rid not in points_order:
            points_order.append(rid)
    groups = [
        [(h, val) for (h, rid2, val) in queries if rid2 == rid]
        for rid in points_order
    ]
    ws = [read_point() for _ in points_order]
    u_ch = g.squeeze()

    mu = None
    if has_accumulator:
        assert num_instance >= 12
        mu = g.squeeze()

    const_cache: dict = {}

    def const_point(pt) -> int:
        if pt not in const_cache:
            const_cache[pt] = g.const_point(pt)
        return const_cache[pt]

    g1 = g1_generator()
    xn_pows = [None] * n_h

    lhs_acc = None
    rhs_acc = None
    upow = None
    for k_i, rid in enumerate(points_order):
        upow = one if k_i == 0 else g.mulf(upow, u_ch)
        # F_k and e_k folds
        fk = None
        ek = None
        vpow = one
        for j, (h, val) in enumerate(groups[k_i]):
            if j > 0:
                vpow = g.mulf(vpow, v_ch)
            if h[0] == "h":
                for a2, hp in enumerate(h[1]):
                    if a2 == 0:
                        coeff = vpow
                    else:
                        if xn_pows[a2] is None:
                            xn_pows[a2] = (
                                xn if a2 == 1 else g.mulf(xn_pows[a2 - 1], xn)
                            )
                        coeff = g.mulf(vpow, xn_pows[a2])
                    tp = hp if (j == 0 and a2 == 0) else g.ec_mul(hp, coeff)
                    fk = tp if fk is None else g.ec_add(fk, tp)
            elif h[0] == "c" and h[1] is None:
                pass  # identity commitment contributes nothing to F_k
            else:
                pslot = h[1] if h[0] == "w" else const_point(h[1])
                tp = pslot if j == 0 else g.ec_mul(pslot, vpow)
                fk = tp if fk is None else g.ec_add(fk, tp)
            term_e = val if j == 0 else g.mulf(vpow, val)
            ek = term_e if ek is None else g.addf(ek, term_e)
        w = ws[k_i]
        z_k = rot_cell_u if rid == "u" else rot_cell(rid)
        # term = z_k*W + F_k - e_k*G
        t1 = g.ec_mul(w, z_k)
        t2 = t1 if fk is None else g.ec_add(t1, fk)
        t3 = g.ec_add(t2, g.ec_neg(g.ec_mul(const_point(g1), ek)))
        # lhs += u^k W ; rhs += u^k term
        wl = w if k_i == 0 else g.ec_mul(w, upow)
        tl = t3 if k_i == 0 else g.ec_mul(t3, upow)
        lhs_acc = wl if lhs_acc is None else g.ec_add(lhs_acc, wl)
        rhs_acc = tl if rhs_acc is None else g.ec_add(rhs_acc, tl)

    if has_accumulator:
        lhs_in, rhs_in = _acc_points_from_limbs(g, inst)
        lhs_acc = g.ec_add(lhs_acc, g.ec_mul(lhs_in, mu))
        rhs_acc = g.ec_add(rhs_acc, g.ec_mul(rhs_in, mu))

    g.pairing_check(lhs_acc, rhs_acc, srs.g2, srs.s_g2)
    runtime, yul = g.finish()
    return gen_deployment(runtime), yul


def _acc_points_from_limbs(g: Gen, inst: list[int]):
    """Reconstruct the inner accumulator points from the first 12 instance
    cells — recomposed with PLAIN integer arithmetic (values < 2^264 fit an
    EVM word NOT: 2^264 > 2^256!). Limbs are 88-bit, so x = l0 + l1<<88 +
    l2<<176 < 2^264 overflows u256 for l2 near 2^88; but canonical Fq
    coordinates are < q < 2^254, whose l2 < 2^78, so the shifted terms fit
    (l2 << 176 < 2^254). Range-check l2 < 2^78 to make the recomposition
    overflow-free, then reduce mod q."""
    pts = []
    for cidx in range(4):
        limbs = inst[cidx * 3 : cidx * 3 + 3]
        g.require_lt(limbs[0], 1 << 88)
        g.require_lt(limbs[1], 1 << 88)
        g.require_lt(limbs[2], 1 << 78)
        # plain ADD/MUL (no overflow), then mod q
        t = g.slot()
        g._push(FQ_MOD)
        g._push(limbs[2])
        g.a.op(MLOAD)
        g._push(1 << 176)
        g.a.op(MUL)
        g._push(limbs[1])
        g.a.op(MLOAD)
        g._push(1 << 88)
        g.a.op(MUL)
        g.a.op(ADD)
        g._push(limbs[0])
        g.a.op(MLOAD)
        g.a.op(ADD)
        g.a.op(MOD)
        g._push(t)
        g.a.op(MSTORE)
        g.yul.append(
            f"  mstore({t:#x}, mod(add(add(mload({limbs[0]:#x}), "
            f"mul(mload({limbs[1]:#x}), {1 << 88:#x})), "
            f"mul(mload({limbs[2]:#x}), {1 << 176:#x})), {FQ_MOD:#x}))"
        )
        pts.append(t)
    lhs = g.point_slot()
    rhs = g.point_slot()
    # copy coord slots into point slots
    for dst, src in ((lhs, pts[0]), (lhs + 32, pts[1]), (rhs, pts[2]), (rhs + 32, pts[3])):
        g._push(src)
        g.a.op(MLOAD)
        g._push(dst)
        g.a.op(MSTORE)
        g.yul.append(f"  mstore({dst:#x}, mload({src:#x}))")
    g._on_curve(lhs)
    g._on_curve(rhs)
    return lhs, rhs


def proof_calldata(instances: list[int], proof: bytes) -> bytes:
    """[instance words BE || proof words BE]. The wire proof is 32-byte
    little-endian words (transcript.py encode); EVM calldata is big-endian,
    so each word is byte-reversed (the reference's BundleProof::calldata
    performs the same splice/encoding, unit_tests.rs:32)."""
    out = b"".join(int(v).to_bytes(32, "big") for v in instances)
    assert len(proof) % 32 == 0, "proof must be whole words"
    for i in range(0, len(proof), 32):
        out += proof[i : i + 32][::-1]
    return bytes(out)
