"""Keccak-f[1600] fully-constrained permutation subcircuit.

The deepening VERDICT round-2 item 2 names: "keccak circuit absorbing real
inputs (host-computed round witnesses, constrained permutation)". Reference
scope: zkevm-circuits' keccak_circuit (SURVEY.md section 2.2).

Lane-parallel, copy-free-in-the-core layout. The 1600-bit state lives in
25 advice columns (lane x+5y -> column), one bit per row, in blocks of 128
rows where row w holds bit (w mod 64) — the duplication makes every
rho/pi rotation a CONSTANT row offset, so each round is pure gates:

    block 2k   (alpha): state entering round r        [+ C/U/V theta parity]
    block 2k+1 (beta):  post-theta state A ^ D        [gate: A, C queries]
    next alpha:         chi(rho/pi(beta)) ^ iota      [25 per-lane gates
                                                       with per-lane rotations]

Rows [0,64) of each block are compute rows; rows [64,128) repeat them
(q_dup), keeping mod-64 rotations in-block. theta's 5-way XOR is a parity
decomposition (sum = C + 2U + 4V over boolean C/U/V), so every gate stays
at degree <= 5 (the backend's free budget).

Sponge binding (per bound event): the init block equals the padded message
bits (boolean M columns); each absorb block equals chi ^ iota ^ M; every
DATA byte of the message is recomposed from its 8 M bits and LOOKED UP in
the bytecode table at (digest_hi, digest_lo, index, byte) with the index
chain constrained — so the bytecode table's claimed code hash is PROVEN to
be keccak256 of its bytes; padding bytes are pinned by fixed constants;
the final state's 256 digest bits are recomposed to (hi, lo) cells that
are copy-constrained into the keccak TABLE row (promoting it from
committed to proven) and into the lookup's digest cells.

Capacity (SPT_KECCAK_CAP) counts PERMUTATIONS: one 136-byte block costs
49 * 128 = 6272 state rows; events are bound smallest-first while they
fit. Default 0 — the columns are only configured when enabled, so the
default ladder shape is unchanged (same convention as the sig circuit).
"""
from __future__ import annotations

from ..fields.bn254 import FR_MOD
from ..hashes.keccak import (
    ROUND_CONSTANTS, chi_sources, keccak256, keccak_f_trace, pad_blocks,
)
from ..proof_system.plonk.cs import ConstraintSystem

RATE = 136  # bytes
BLOCK = 128  # rows per state block
ROUNDS = 24


def _bit(lane: int, z: int) -> int:
    return (lane >> z) & 1


def _xor(a, b):
    return a + b - 2 * a * b


class KeccakFSubCircuit:
    def configure(self, cs: ConstraintSystem, bytecode, keccak_tbl, cap: int):
        self.cap = cap
        if not cap:
            return self
        self.A = [cs.advice_column() for _ in range(25)]
        self.C = [cs.advice_column() for _ in range(5)]
        self.U = [cs.advice_column() for _ in range(5)]
        self.V = [cs.advice_column() for _ in range(5)]
        self.M = [cs.advice_column() for _ in range(17)]
        self.T = cs.advice_column()  # lane-0 chi staging on absorb rows
        self.rc = cs.fixed_column()  # iota round-constant bit per row
        self.q_dup = cs.fixed_column()
        self.q_init = cs.fixed_column()
        self.q_c = cs.fixed_column()
        self.q_ap = cs.fixed_column()
        self.q_chi = cs.fixed_column()
        self.q_abs = cs.fixed_column()

        A = [c.query() for c in self.A]
        dup = self.q_dup.query()
        for j in range(25):
            cs.gate(f"keccak/dup_{j}", dup * (A[j] - self.A[j].query(-64)))
        qi = self.q_init.query()
        for j in range(25):
            if j < 17:
                m = self.M[j].query()
                cs.gate(f"keccak/init_{j}", qi * (A[j] - m))
            else:
                cs.gate(f"keccak/init_{j}", qi * A[j])
        qc = self.q_c.query()
        for x in range(5):
            s = 0
            for y in range(5):
                s = s + A[x + 5 * y]
            c, u, v = self.C[x].query(), self.U[x].query(), self.V[x].query()
            cs.gate(f"keccak/parity_{x}", qc * (s - c - 2 * u - 4 * v))
            cs.gate(f"keccak/c_bool_{x}", qc * c * (c - 1))
            cs.gate(f"keccak/u_bool_{x}", qc * u * (u - 1))
            cs.gate(f"keccak/v_bool_{x}", qc * v * (v - 1))
        qa = self.q_ap.query()
        for y in range(5):
            for x in range(5):
                j = x + 5 * y
                cm = self.C[(x - 1) % 5].query(-BLOCK)
                cp = self.C[(x + 1) % 5].query(-(BLOCK // 2) - 1)
                d = _xor(cm, cp)
                prev = self.A[j].query(-BLOCK)
                cs.gate(f"keccak/theta_{j}", qa * (A[j] - _xor(prev, d)))

        def chi_expr(x, y):
            srcs = chi_sources(x, y)
            b = [self.A[sl].query(-64 - rot) for sl, rot in srcs]
            # b0 ^ (~b1 & b2)
            g = b[2] - b[1] * b[2]
            return b[0] + g - 2 * b[0] * g

        qx = self.q_chi.query()
        qb = self.q_abs.query()
        rc = self.rc.query()
        for y in range(5):
            for x in range(5):
                j = x + 5 * y
                e = chi_expr(x, y)
                out = _xor(e, rc) if j == 0 else e
                cs.gate(f"keccak/chi_{j}", qx * (A[j] - out))
                if j == 0:
                    t = self.T.query()
                    m0 = self.M[0].query()
                    cs.gate("keccak/abs_t", qb * (t - e))
                    cs.gate(
                        "keccak/abs_0", qb * (A[0] - _xor(_xor(t, rc), m0))
                    )
                elif j < 17:
                    m = self.M[j].query()
                    cs.gate(f"keccak/abs_{j}", qb * (A[j] - _xor(e, m)))
                else:
                    cs.gate(f"keccak/abs_{j}", qb * (A[j] - e))
        for j in range(17):
            m = self.M[j].query()
            cs.gate(f"keccak/m_bool_{j}", (qi + qb) * m * (m - 1))

        # -- byte/digest recomposition region (own columns) ----------------
        self.kb = cs.advice_column()
        self.kacc = cs.advice_column()
        self.kidx = cs.advice_column()
        self.kd_hi = cs.advice_column()
        self.kd_lo = cs.advice_column()
        self.klen = cs.advice_column()
        self.pw = cs.fixed_column()
        self.padv = cs.fixed_column()
        self.q_kb = cs.fixed_column()  # chain rows (kacc continues)
        self.q_kb_first = cs.fixed_column()
        self.q_look = cs.fixed_column()  # data-byte rows: bytecode lookup
        self.q_pad = cs.fixed_column()  # padding-byte rows: fixed value
        self.q_idx0 = cs.fixed_column()
        self.q_idxn = cs.fixed_column()
        self.q_len = cs.fixed_column()
        kb, kacc = self.kb.query(), self.kacc.query()
        pw = self.pw.query()
        qkb, qkf = self.q_kb.query(), self.q_kb_first.query()
        cs.gate("keccak/kb_bool", (qkb + qkf) * kb * (kb - 1))
        cs.gate("keccak/kacc_first", qkf * (kacc - kb * pw))
        cs.gate("keccak/kacc_chain", qkb * (kacc - self.kacc.query(-1) - kb * pw))
        ql = self.q_look.query()
        cs.gate("keccak/pad", self.q_pad.query() * (kacc - self.padv.query()))
        cs.gate("keccak/idx0", self.q_idx0.query() * self.kidx.query())
        cs.gate(
            "keccak/idx_chain",
            self.q_idxn.query() * (self.kidx.query() - self.kidx.query(-8) - 1),
        )
        cs.gate(
            "keccak/kd_hi_const",
            self.q_idxn.query() * (self.kd_hi.query() - self.kd_hi.query(-8)),
        )
        cs.gate(
            "keccak/kd_lo_const",
            self.q_idxn.query() * (self.kd_lo.query() - self.kd_lo.query(-8)),
        )
        cs.gate(
            "keccak/len_bind",
            self.q_len.query() * (self.klen.query() - self.kidx.query() - 1),
        )
        cs.lookup(
            "keccak/bytecode",
            [
                ql * self.kd_hi.query(),
                ql * self.kd_lo.query(),
                ql * self.kidx.query(),
                ql * kacc,
            ],
            bytecode.table_exprs(),
        )
        for col in (
            self.kb, self.kacc, self.kd_hi, self.kd_lo, self.klen,
            keccak_tbl.len, keccak_tbl.hash_hi, keccak_tbl.hash_lo,
            *self.A, *self.M,
        ):
            cs.enable_permutation(col)
        return self

    # -- event selection -----------------------------------------------------

    @staticmethod
    def bound_events(wb, cap: int):
        """(event, n_blocks) picks, smallest-first, total perms <= cap;
        only events whose preimage is bytecode (the lookup's table)."""
        if not cap:
            return []
        cands = []
        for ev in wb.keccak_events:
            if keccak256(ev.preimage).hex() in wb.bytecode_map:
                cands.append((len(pad_blocks(ev.preimage)), ev))
        cands.sort(key=lambda t: (t[0], t[1].digest))
        out, left = [], cap
        for nb, ev in cands:
            if nb <= left:
                out.append((ev, nb))
                left -= nb
        return out

    def rows_for(self, wb, cap: int) -> tuple[int, int]:
        """(state_rows, recompose_rows) the bound events occupy."""
        picks = self.bound_events(wb, cap)
        srows = sum(BLOCK * (1 + 2 * ROUNDS * nb) for _ev, nb in picks)
        brows = sum(nb * RATE * 8 + 256 + 16 for _ev, nb in picks)
        return srows, brows

    # -- assignment ------------------------------------------------------------

    def _write_block(self, adv, base, lanes):
        for j in range(25):
            col = adv[self.A[j].index]
            for w in range(BLOCK):
                col[base + w] = _bit(lanes[j], w % 64)

    def _write_cuv(self, cs, fixed, adv, base, lanes):
        fixedq = fixed[self.q_c.index]
        for w in range(BLOCK):
            fixedq[base + w] = 1
            z = w % 64
            for x in range(5):
                s = sum(_bit(lanes[x + 5 * y], z) for y in range(5))
                adv[self.C[x].index][base + w] = s & 1
                adv[self.U[x].index][base + w] = (s >> 1) & 1
                adv[self.V[x].index][base + w] = (s >> 2) & 1

    def assign(self, cs, fixed, adv, n, wb, row0: int,
               keccak_tbl, keccak_row_of) -> int:
        """Returns rows used (state region). keccak_row_of maps a digest
        (bytes) to its row in the keccak table (for the digest copies)."""
        picks = self.bound_events(wb, self.cap)
        if not picks:
            return 0
        base = row0
        brow = 0  # recompose-region cursor (own columns)
        for ev, _nb in picks:
            base, brow = self._assign_event(
                cs, fixed, adv, base, brow, ev, keccak_tbl, keccak_row_of
            )
        return base - row0

    def _assign_event(self, cs, fixed, adv, base, brow, ev,
                      keccak_tbl, keccak_row_of):
        blocks = pad_blocks(ev.preimage)
        state = [0] * 25
        msg_cells = []  # (byte_index_global, [(col, row) x8 bits])
        first_block_base = None
        for bi, blk in enumerate(blocks):
            lanes_m = [
                int.from_bytes(blk[8 * i : 8 * i + 8], "little")
                for i in range(17)
            ]
            state_in = list(state)
            for i in range(17):
                state[i] ^= lanes_m[i]
            # init or absorb block holds the post-absorb state
            if bi == 0:
                first_block_base = base
                self._write_block(adv, base, state)
                for w in range(64):
                    fixed[self.q_init.index][base + w] = 1
                    fixed[self.q_dup.index][base + 64 + w] = 1
            else:
                # absorb block: already written as the previous perm's
                # output block — rewrite with the absorbed state and mark
                self._write_block(adv, base, state)
                for w in range(64):
                    fixed[self.q_abs.index][base + w] = 1
                    fixed[self.q_dup.index][base + 64 + w] = 1
                    fixed[self.rc.index][base + w] = _bit(
                        ROUND_CONSTANTS[ROUNDS - 1], w
                    )
                    # T = chi (pre-iota, pre-absorb) of lane 0
                    pre = state_in[0] ^ ROUND_CONSTANTS[ROUNDS - 1]
                    adv[self.T.index][base + w] = _bit(pre, w)
            # M cells for this block
            for j in range(17):
                col = adv[self.M[j].index]
                for w in range(64):
                    col[base + w] = _bit(lanes_m[j], w)
            for local in range(RATE):
                l, k = local // 8, local % 8
                cells = [
                    (self.M[l], base + 8 * k + i) for i in range(8)
                ]
                msg_cells.append(cells)
            self._write_cuv(cs, fixed, adv, base, state)
            # rounds
            states, thetas = keccak_f_trace(state)
            for r in range(ROUNDS):
                bbase = base + BLOCK
                self._write_block(adv, bbase, thetas[r])
                for w in range(64):
                    fixed[self.q_ap.index][bbase + w] = 1
                    fixed[self.q_dup.index][bbase + 64 + w] = 1
                abase = bbase + BLOCK
                self._write_block(adv, abase, states[r + 1])
                is_last_round = r == ROUNDS - 1
                is_last_block = bi == len(blocks) - 1
                if not is_last_round or is_last_block:
                    # plain chi rows (the absorb variant is marked when
                    # the NEXT block is written)
                    for w in range(64):
                        fixed[self.q_chi.index][abase + w] = (
                            0 if (is_last_round and not is_last_block) else 1
                        )
                        fixed[self.q_dup.index][abase + 64 + w] = 1
                        fixed[self.rc.index][abase + w] = _bit(
                            ROUND_CONSTANTS[r], w
                        )
                    if not is_last_round:
                        self._write_cuv(cs, fixed, adv, abase, states[r + 1])
                else:
                    # next block will overwrite with the absorbed state
                    for w in range(64):
                        fixed[self.q_dup.index][abase + 64 + w] = 1
                base = abase
                state = states[r + 1]
            # `base` now points at this perm's output block
        final_base = base
        base += BLOCK

        # -- digest recomposition (hi, lo) ---------------------------------
        digest = keccak256(ev.preimage)
        acc_cells = []
        for half in range(2):
            acc = 0
            for k in range(16):
                gk = 16 * half + k
                lane_col = self.A[gk // 8]
                for i in range(8):
                    z = 8 * (gk % 8) + i
                    p = pow(2, i, FR_MOD) * pow(256, 15 - k, FR_MOD) % FR_MOD
                    bit = (digest[gk] >> i) & 1
                    adv[self.kb.index][brow] = bit
                    fixed[self.pw.index][brow] = p
                    if k == 0 and i == 0:
                        fixed[self.q_kb_first.index][brow] = 1
                    else:
                        fixed[self.q_kb.index][brow] = 1
                    acc = (acc + bit * p) % FR_MOD
                    adv[self.kacc.index][brow] = acc
                    cs.copy(self.kb, brow, lane_col, final_base + z)
                    brow += 1
            acc_cells.append((self.kacc, brow - 1, acc))
        (hi_col, hi_row, hi_v), (lo_col, lo_row, lo_v) = acc_cells
        assert hi_v == int.from_bytes(digest[:16], "big")
        assert lo_v == int.from_bytes(digest[16:], "big")
        trow = keccak_row_of(ev.digest)
        cs.copy(keccak_tbl.hash_hi, trow, hi_col, hi_row)
        cs.copy(keccak_tbl.hash_lo, trow, lo_col, lo_row)

        # -- message bytes: recompose + bytecode lookup / pad pin ----------
        data_len = len(ev.preimage)
        padded = bytearray(ev.preimage) + b"\x00" * (
            len(blocks) * RATE - data_len
        )
        padded[data_len] ^= 0x01
        padded[-1] ^= 0x80
        first_look = None
        last_look = None
        for j, cells in enumerate(msg_cells):
            byte = padded[j]
            acc = 0
            for i in range(8):
                bit = (byte >> i) & 1
                adv[self.kb.index][brow] = bit
                fixed[self.pw.index][brow] = 1 << i
                if i == 0:
                    fixed[self.q_kb_first.index][brow] = 1
                else:
                    fixed[self.q_kb.index][brow] = 1
                acc += bit << i
                adv[self.kacc.index][brow] = acc
                col, row = cells[i]
                cs.copy(self.kb, brow, col, row)
                brow += 1
            last = brow - 1
            if j < data_len:
                fixed[self.q_look.index][last] = 1
                adv[self.kidx.index][last] = j
                adv[self.kd_hi.index][last] = hi_v
                adv[self.kd_lo.index][last] = lo_v
                if first_look is None:
                    first_look = last
                    fixed[self.q_idx0.index][last] = 1
                    cs.copy(self.kd_hi, last, hi_col, hi_row)
                    cs.copy(self.kd_lo, last, lo_col, lo_row)
                else:
                    fixed[self.q_idxn.index][last] = 1
                last_look = last
            else:
                fixed[self.q_pad.index][last] = 1
                fixed[self.padv.index][last] = byte
        if last_look is not None:
            fixed[self.q_len.index][last_look] = 1
            adv[self.klen.index][last_look] = data_len
            cs.copy(self.klen, last_look, keccak_tbl.len, trow)
        brow += 8  # region gap (keeps -8 rotations from crossing events)
        return base, brow
