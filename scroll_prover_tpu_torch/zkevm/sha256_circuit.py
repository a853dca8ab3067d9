"""SHA-256 fully-constrained compression subcircuit.

Reference scope: halo2_gadgets' sha256 as consumed for the 0x02 precompile
(SURVEY.md section 2.2). Same block-duplication technique as the keccak-f
circuit: each 32-bit word lives in a 64-row block of a bit column — row w
holds bit (w mod 32) — so ROTR is a constant row offset and SHR a rotated
read under a fixed mask column.

Grid (per 512-bit message block, shared 64-row blocks across column sets):
  blocks 0..3   : preamble — A/E bit chains hold (d,c,b,a) / (h,g,f,e) =
                  the incoming H state (fixed H0 bits for the first block;
                  copy-chained from the previous block's H_out otherwise)
  blocks 4..67  : round t = block 4+t;  schedule word W_t in the SAME block
      schedule:  WB bits (blocks 4..19 = padded message bits, boolean;
                 20..67 computed), S0B/S1B sigma images, word cells + a
                 carry-decomposed schedule addition
      rounds:    CH/MJ/SA/SE helper bits (Ch = g + e*(f-g), Maj, XOR3
                 Sigmas over rotated reads of the A/E chains), word cells,
                 and the two carry-decomposed state additions
  digest rows   : hout_i = h_in_i + state_i (copy-bound word cells), then
                  (d_hi, d_lo) recomposed EXACTLY from the 8 hout words and
                  copy-constrained into the event's table row; the padded
                  length word W15 of the last block is gate-bound to the
                  table's len cell.

The message bits themselves are existential witnesses (the statement is
"table digest = SHA-256 of a len-byte message"); pinning the padding bit
pattern and cross-binding input bytes to the copy table is the designated
deepening. Capacity (SPT_SHA256_CAP) counts 512-bit blocks (~4.4k rows
each); smallest events bound first; default 0 configures no columns."""
from __future__ import annotations

import struct

from ..proof_system.plonk.cs import ConstraintSystem

BLOCK = 64
ROUNDS = 64
PRE = 4  # preamble blocks

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
M32 = (1 << 32) - 1


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & M32


def sha256_blocks(data: bytes) -> list[list[int]]:
    pad = data + b"\x80"
    pad += b"\x00" * ((56 - len(pad)) % 64)
    pad += (8 * len(data)).to_bytes(8, "big")
    return [
        list(struct.unpack(">16I", pad[o : o + 64]))
        for o in range(0, len(pad), 64)
    ]


def sha256_trace(blocks):
    """Per block: (w[64], s0[64], s1[64], carW[64], a[64], e[64],
    carA[64], carE[64], h_in, h_out)."""
    h = list(H0)
    out = []
    for blk in blocks:
        w = list(blk)
        s0l, s1l, cwl = [0] * 16, [0] * 16, [0] * 16
        for t in range(16, 64):
            x0, x1 = w[t - 15], w[t - 2]
            s0 = _rotr(x0, 7) ^ _rotr(x0, 18) ^ (x0 >> 3)
            s1 = _rotr(x1, 17) ^ _rotr(x1, 19) ^ (x1 >> 10)
            tot = w[t - 16] + s0 + w[t - 7] + s1
            w.append(tot & M32)
            s0l.append(s0)
            s1l.append(s1)
            cwl.append(tot >> 32)
        a, b, c, d, e, f, g, hh = h
        al, el, cal, cel = [], [], [], []
        chl, mjl, sal, sel_ = [], [], [], []
        for t in range(64):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ ((~e) & g)
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            mj = (a & b) ^ (a & c) ^ (b & c)
            te = d + hh + S1 + ch + K[t] + w[t]
            ta = hh + S1 + ch + K[t] + w[t] + S0 + mj
            e_new, a_new = te & M32, ta & M32
            cel.append(te >> 32)
            cal.append(ta >> 32)
            chl.append(ch)
            mjl.append(mj)
            sal.append(S0)
            sel_.append(S1)
            hh, g, f, e = g, f, e, e_new
            d, c, b, a = c, b, a, a_new
            al.append(a)
            el.append(e)
        h_in = list(h)
        h = [(x + y) & M32 for x, y in zip(h, [a, b, c, d, e, f, g, hh])]
        out.append((w, s0l, s1l, cwl, al, el, cal, cel,
                    chl, mjl, sal, sel_, h_in, list(h)))
    return out, h


def sha256_host(data: bytes) -> bytes:
    _t, h = sha256_trace(sha256_blocks(data))
    return b"".join(x.to_bytes(4, "big") for x in h)


def _bit(w, z):
    return (w >> z) & 1


class Sha256SubCircuit:
    def configure(self, cs: ConstraintSystem, cap: int):
        self.cap = cap
        self.q = cs.fixed_column()  # event table rows
        self.len_col = cs.advice_column()
        self.d_hi = cs.advice_column()
        self.d_lo = cs.advice_column()
        if not cap:
            return self
        adv, fx = cs.advice_column, cs.fixed_column
        self.WB, self.S0B, self.S1B = adv(), adv(), adv()
        self.wW, self.wS0, self.wS1 = adv(), adv(), adv()
        self.cW = [adv(), adv()]
        self.A, self.E = adv(), adv()
        self.CH, self.MJ, self.SA, self.SE = adv(), adv(), adv(), adv()
        self.wA, self.wE = adv(), adv()
        self.wCH, self.wMJ, self.wSA, self.wSE = adv(), adv(), adv(), adv()
        self.cA = [adv(), adv(), adv()]
        self.cE = [adv(), adv(), adv()]
        self.hout = adv()
        self.cH = adv()
        self.Kcol = fx()
        self.hfix_a, self.hfix_e = fx(), fx()  # first-block preamble bits
        self.q_dup = fx()
        self.q_mbit = fx()
        self.q_wbit = fx()
        self.q_wword = fx()
        self.q_rbit = fx()
        self.q_rword = fx()
        self.q_pre = fx()  # first-block preamble compute rows
        self.q_prec = fx()  # chained preamble compute rows (bool only)
        self.q_preword = fx()  # preamble word rows
        self.q_hword = fx()
        self.q_dig = fx()
        self.q_lenw = fx()
        self.mask3, self.mask10 = fx(), fx()

        dup = self.q_dup.query()
        bitcols = (self.WB, self.S0B, self.S1B, self.A, self.E,
                   self.CH, self.MJ, self.SA, self.SE)
        for col in bitcols:
            cs.gate(f"sha/dup_{col.index}",
                    dup * (col.query() - col.query(-32)))
        qm, qw = self.q_mbit.query(), self.q_wbit.query()
        WB = self.WB.query()
        cs.gate("sha/m_bool", (qm + qw) * WB * (WB - 1))
        qp, qpc = self.q_pre.query(), self.q_prec.query()
        Aq, Eq = self.A.query(), self.E.query()
        cs.gate("sha/pre_fix_a", qp * (Aq - self.hfix_a.query()))
        cs.gate("sha/pre_fix_e", qp * (Eq - self.hfix_e.query()))
        cs.gate("sha/prec_bool_a", qpc * Aq * (Aq - 1))
        cs.gate("sha/prec_bool_e", qpc * Eq * (Eq - 1))

        def xor3(x, y, z):
            return (x + y + z - 2 * (x * y + x * z + y * z)
                    + 4 * x * y * z)

        def wq(back, rot):
            return self.WB.query(-BLOCK * back + rot)

        cs.gate(
            "sha/s0_def",
            qw * (self.S0B.query()
                  - xor3(wq(15, 7), wq(15, 18),
                         self.mask3.query() * wq(15, 3))),
        )
        cs.gate(
            "sha/s1_def",
            qw * (self.S1B.query()
                  - xor3(wq(2, 17), wq(2, 19),
                         self.mask10.query() * wq(2, 10))),
        )

        def word_of(col):
            acc = 0
            for z in range(32):
                acc = acc + (1 << z) * col.query(z)
            return acc

        qww = self.q_wword.query()
        cs.gate("sha/wW_def", qww * (self.wW.query() - word_of(self.WB)))
        cs.gate("sha/wS0_def", qww * (self.wS0.query() - word_of(self.S0B)))
        cs.gate("sha/wS1_def", qww * (self.wS1.query() - word_of(self.S1B)))
        # message blocks also carry their word cell (for W reads + len bind)
        self.q_mword = cs.fixed_column()
        qmw = self.q_mword.query()
        cs.gate("sha/mW_def", qmw * (self.wW.query() - word_of(self.WB)))
        for c in self.cW:
            cq = c.query()
            cs.gate(f"sha/cwb_{c.index}", qww * cq * (cq - 1))
        carW = self.cW[0].query() + 2 * self.cW[1].query()
        cs.gate(
            "sha/schedule_add",
            qww * (self.wW.query() + (1 << 32) * carW
                   - self.wW.query(-16 * BLOCK) - self.wS0.query()
                   - self.wW.query(-7 * BLOCK) - self.wS1.query()),
        )
        qr = self.q_rbit.query()
        for col in (self.A, self.E, self.CH, self.MJ, self.SA, self.SE):
            cq = col.query()
            cs.gate(f"sha/rb_{col.index}", qr * cq * (cq - 1))

        def aq(back, rot=0):
            return self.A.query(-BLOCK * back + rot)

        def eq2(back, rot=0):
            return self.E.query(-BLOCK * back + rot)

        e1, f1, g1 = eq2(1), eq2(2), eq2(3)
        cs.gate("sha/ch_def", qr * (self.CH.query() - g1 - e1 * (f1 - g1)))
        a1, b1, c1 = aq(1), aq(2), aq(3)
        cs.gate("sha/mj_def",
                qr * (self.MJ.query() - a1 * b1 - a1 * c1 - b1 * c1
                      + 2 * a1 * b1 * c1))
        cs.gate("sha/sa_def",
                qr * (self.SA.query() - xor3(aq(1, 2), aq(1, 13), aq(1, 22))))
        cs.gate("sha/se_def",
                qr * (self.SE.query() - xor3(eq2(1, 6), eq2(1, 11), eq2(1, 25))))
        qrw = self.q_rword.query()
        for wcol, bcol in ((self.wA, self.A), (self.wE, self.E),
                           (self.wCH, self.CH), (self.wMJ, self.MJ),
                           (self.wSA, self.SA), (self.wSE, self.SE)):
            cs.gate(f"sha/wd_{wcol.index}",
                    qrw * (wcol.query() - word_of(bcol)))
        qpw = self.q_preword.query()
        cs.gate("sha/pwd_a", qpw * (self.wA.query() - word_of(self.A)))
        cs.gate("sha/pwd_e", qpw * (self.wE.query() - word_of(self.E)))
        for cols in (self.cA, self.cE):
            for c in cols:
                cq = c.query()
                cs.gate(f"sha/cb_{c.index}", qrw * cq * (cq - 1))
        carA = (self.cA[0].query() + 2 * self.cA[1].query()
                + 4 * self.cA[2].query())
        carE = (self.cE[0].query() + 2 * self.cE[1].query()
                + 4 * self.cE[2].query())
        t1 = (self.wE.query(-4 * BLOCK) + self.wSE.query()
              + self.wCH.query() + self.Kcol.query() + self.wW.query())
        cs.gate(
            "sha/e_add",
            qrw * (self.wE.query() + (1 << 32) * carE
                   - self.wA.query(-4 * BLOCK) - t1),
        )
        cs.gate(
            "sha/a_add",
            qrw * (self.wA.query() + (1 << 32) * carA
                   - t1 - self.wSA.query() - self.wMJ.query()),
        )
        qh = self.q_hword.query()
        ch_ = self.cH.query()
        cs.gate("sha/hc_bool", qh * ch_ * (ch_ - 1))
        cs.gate("sha/h_add",
                qh * (self.hout.query() + (1 << 32) * ch_
                      - self.wA.query() - self.wE.query()))
        # digest halves from the 8 hout rows (laid consecutively)
        qd = self.q_dig.query()
        hi = 0
        lo = 0
        for i in range(4):
            hi = hi + (1 << (32 * (3 - i))) * self.hout.query(i)
            lo = lo + (1 << (32 * (3 - i))) * self.hout.query(4 + i)
        cs.gate("sha/d_hi", qd * (self.d_hi.query() - hi))
        cs.gate("sha/d_lo", qd * (self.d_lo.query() - lo))
        # the last block's W15 word == 8 * message length (padding bind)
        ql = self.q_lenw.query()
        cs.gate("sha/len_bind", ql * (self.wW.query() - 8 * self.len_col.query()))
        for col in (self.d_hi, self.d_lo, self.len_col, self.hout,
                    self.wA, self.wE):
            cs.enable_permutation(col)
        return self

    # -- events ----------------------------------------------------------

    @staticmethod
    def events(wb):
        return list(getattr(wb, "sha256_raw", []))

    def picks(self, wb, cap: int):
        if not cap:
            return []
        cands = []
        for inp, out in self.events(wb):
            if len(out) >= 32 and sha256_host(inp) == out[:32]:
                cands.append((len(sha256_blocks(inp)), inp, out))
        cands.sort(key=lambda t: (t[0], t[2]))
        picked, left = [], cap
        for nb, inp, out in cands:
            if nb <= left:
                picked.append((inp, out))
                left -= nb
        return picked

    def rows_for(self, wb, cap: int) -> tuple[int, int]:
        table = len(self.events(wb))
        grid = sum(
            (PRE + ROUNDS) * BLOCK * len(sha256_blocks(inp)) + 16
            for inp, _o in self.picks(wb, cap)
        )
        return table, grid

    # -- assignment --------------------------------------------------------

    def assign(self, cs, fixed, adv, n, wb, row0: int) -> int:
        events = self.events(wb)
        r = row0
        table_rows = {}
        for inp, out in events:
            fixed[self.q.index][r] = 1
            adv[self.len_col.index][r] = len(inp)
            d = int.from_bytes(out[:32].ljust(32, b"\x00"), "big")
            adv[self.d_hi.index][r] = d >> 128
            adv[self.d_lo.index][r] = d & ((1 << 128) - 1)
            table_rows[(bytes(inp), bytes(out))] = r
            r += 1
        if self.cap:
            grid = r
            for inp, out in self.picks(wb, self.cap):
                grid = self._assign_event(
                    cs, fixed, adv, grid, inp,
                    table_rows[(bytes(inp), bytes(out))],
                )
            r = grid
        return r - row0

    def _write_block(self, adv, col, base, word):
        a = adv[col.index]
        for w in range(BLOCK):
            a[base + w] = _bit(word, w % 32)

    def _assign_event(self, cs, fixed, adv, base, inp, trow) -> int:
        blocks = sha256_blocks(inp)
        trace, _h = sha256_trace(blocks)
        prev_h_cells = None  # (col,row) of previous block's 8 hout cells
        for bi, blk in enumerate(blocks):
            (w, s0l, s1l, cwl, al, el, cal, cel,
             chl, mjl, sal, sel_, h_in, h_out) = trace[bi]
            # preamble: A holds d,c,b,a = h_in[3],h_in[2],h_in[1],h_in[0]
            # E holds h,g,f,e = h_in[7..4]
            for pi in range(PRE):
                pb = base + pi * BLOCK
                wa = h_in[3 - pi]
                we = h_in[7 - pi]
                self._write_block(adv, self.A, pb, wa)
                self._write_block(adv, self.E, pb, we)
                adv[self.wA.index][pb] = wa
                adv[self.wE.index][pb] = we
                fixed[self.q_preword.index][pb] = 1
                for z in range(32):
                    if bi == 0:
                        fixed[self.q_pre.index][pb + z] = 1
                        fixed[self.hfix_a.index][pb + z] = _bit(wa, z)
                        fixed[self.hfix_e.index][pb + z] = _bit(we, z)
                    else:
                        fixed[self.q_prec.index][pb + z] = 1
                    fixed[self.q_dup.index][pb + 32 + z] = 1
                if bi > 0:
                    # chain: preamble word == previous block's hout word
                    cs.copy(self.wA, pb, *prev_h_cells[3 - pi])
                    cs.copy(self.wE, pb, *prev_h_cells[7 - pi])
            # 64 round/schedule blocks
            for t in range(ROUNDS):
                tb = base + (PRE + t) * BLOCK
                self._write_block(adv, self.WB, tb, w[t])
                adv[self.wW.index][tb] = w[t]
                self._write_block(adv, self.A, tb, al[t])
                self._write_block(adv, self.E, tb, el[t])
                self._write_block(adv, self.CH, tb, chl[t])
                self._write_block(adv, self.MJ, tb, mjl[t])
                self._write_block(adv, self.SA, tb, sal[t])
                self._write_block(adv, self.SE, tb, sel_[t])
                adv[self.wA.index][tb] = al[t]
                adv[self.wE.index][tb] = el[t]
                adv[self.wCH.index][tb] = chl[t]
                adv[self.wMJ.index][tb] = mjl[t]
                adv[self.wSA.index][tb] = sal[t]
                adv[self.wSE.index][tb] = sel_[t]
                fixed[self.Kcol.index][tb] = K[t]
                fixed[self.q_rword.index][tb] = 1
                for i, c in enumerate(self.cA):
                    adv[c.index][tb] = (cal[t] >> i) & 1
                for i, c in enumerate(self.cE):
                    adv[c.index][tb] = (cel[t] >> i) & 1
                if t >= 16:
                    self._write_block(adv, self.S0B, tb, s0l[t])
                    self._write_block(adv, self.S1B, tb, s1l[t])
                    adv[self.wS0.index][tb] = s0l[t]
                    adv[self.wS1.index][tb] = s1l[t]
                    fixed[self.q_wword.index][tb] = 1
                    for i, c in enumerate(self.cW):
                        adv[c.index][tb] = (cwl[t] >> i) & 1
                else:
                    fixed[self.q_mword.index][tb] = 1
                    if bi == len(blocks) - 1 and t == 15:
                        fixed[self.q_lenw.index][tb] = 1
                        adv[self.len_col.index][tb] = len(inp)
                        cs.copy(self.len_col, tb, self.len_col, trow)
                for z in range(32):
                    if t >= 16:
                        fixed[self.q_wbit.index][tb + z] = 1
                    else:
                        fixed[self.q_mbit.index][tb + z] = 1
                    fixed[self.q_rbit.index][tb + z] = 1
                    fixed[self.mask3.index][tb + z] = int(z < 29)
                    fixed[self.mask10.index][tb + z] = int(z < 22)
                    fixed[self.q_dup.index][tb + 32 + z] = 1
            # digest rows
            dig = base + (PRE + ROUNDS) * BLOCK
            state = [al[63], al[62], al[61], al[60],
                     el[63], el[62], el[61], el[60]]
            h_cells = []
            for i in range(8):
                row = dig + i
                fixed[self.q_hword.index][row] = 1
                adv[self.wA.index][row] = h_in[i]
                adv[self.wE.index][row] = state[i]
                tot = h_in[i] + state[i]
                adv[self.hout.index][row] = tot & M32
                adv[self.cH.index][row] = tot >> 32
                # bind the operands: h_in from the preamble cells, the
                # final state from the last four round blocks' word cells
                if i < 4:
                    cs.copy(self.wA, row, self.wA, base + (3 - i) * BLOCK)
                else:
                    cs.copy(self.wA, row, self.wE, base + (7 - i) * BLOCK)
                last = base + (PRE + 63 - (i % 4)) * BLOCK
                cs.copy(self.wE, row, self.wA if i < 4 else self.wE, last)
                h_cells.append((self.hout, row))
            prev_h_cells = h_cells
            if bi == len(blocks) - 1:
                d = int.from_bytes(
                    b"".join(x.to_bytes(4, "big")
                             for x in trace[bi][13]), "big"
                )
                fixed[self.q_dig.index][dig] = 1
                adv[self.d_hi.index][dig] = d >> 128
                adv[self.d_lo.index][dig] = d & ((1 << 128) - 1)
                cs.copy(self.d_hi, dig, self.d_hi, trow)
                cs.copy(self.d_lo, dig, self.d_lo, trow)
            base = dig + 16
        return base
