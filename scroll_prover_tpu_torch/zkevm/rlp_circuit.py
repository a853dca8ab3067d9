"""RLP subcircuit: constrained structural parsing of REAL signing payloads.

Reference scope: zkevm-circuits' rlp_circuit, which verifies the RLP
encoding of every transaction (SURVEY.md section 2.2). Here each signed
legacy (type-0) tx's signing payload — the exact bytes whose keccak is the
ECDSA message hash in the sig table — is laid out one byte per row and
parsed by a constrained state machine:

  outer list header (fixed-selector rows: short form, or 0xf8/0xf9 long
  form with length bytes) -> a stream of flat string items, each
  HDR -> [LEN bytes ->] PAY bytes, with

  * header classification proven by range lookups (single byte < 0x80;
    short string length in [0,56); long string 0xb8/0xb9),
  * length accumulators and per-phase countdowns chained by gates,
  * the outer header's declared length counted down to exactly the body,
  * an item counter, and the 6th item's (the calldata's) length LOOKED UP
    in the tx table at (tx_id, data_len) — the parsed structure is bound
    to the transaction that signed it,
  * every byte range-checked.

Typed (EIP-2718) payloads and canonical-minimality checks are the
designated deepening; nested access lists need a depth stack."""
from __future__ import annotations

from ..fields.bn254 import FR_MOD as FRM
from ..proof_system.plonk.cs import ConstraintSystem
from ..witness.block import WitnessBlock


class RlpSubCircuit:
    def configure(self, cs: ConstraintSystem, byte_table, tx):
        adv = cs.advice_column
        fx = cs.fixed_column
        self.byte = adv()
        self.ph, self.pl, self.pp = adv(), adv(), adv()  # one-hot state
        self.cs_, self.cm, self.cl = adv(), adv(), adv()  # header class
        self.rem = adv()
        self.lacc = adv()
        self.ilen = adv()
        self.itm = adv()
        self.i5 = adv()
        self.z = adv()
        self.inv = adv()
        self.invI = adv()
        self.txid = adv()
        self.brem = adv()
        # materialized lookup indicators (lookup inputs must stay <= deg 2)
        self.hs = adv()
        self.hm = adv()
        self.look = adv()
        self.q_all = fx()
        self.q_body = fx()
        self.q_tr = fx()
        self.q_b0 = fx()
        self.q_b0s = fx()
        self.q_b0l = fx()
        self.q_ohs = fx()
        self.q_ohl1 = fx()
        self.q_ohl2 = fx()
        self.q_oln0 = fx()
        self.q_oln1 = fx()
        self.q_elast = fx()
        self.t56 = fx()
        self.t128 = fx()

        b = self.byte.query()
        ph, pl, pp = self.ph.query(), self.pl.query(), self.pp.query()
        csq, cm, cl = self.cs_.query(), self.cm.query(), self.cl.query()
        rem, lacc = self.rem.query(), self.lacc.query()
        ilen, itm, i5 = self.ilen.query(), self.itm.query(), self.i5.query()
        z, inv, invI = self.z.query(), self.inv.query(), self.invI.query()
        txid, brem = self.txid.query(), self.brem.query()
        qb, qt = self.q_body.query(), self.q_tr.query()

        for name, c in (("ph", ph), ("pl", pl), ("pp", pp), ("cs", csq),
                        ("cm", cm), ("cl", cl), ("i5", i5), ("z", z)):
            cs.gate(f"rlp/bool_{name}", qb * c * (c - 1))
        cs.gate("rlp/one_hot", qb * (ph + pl + pp - 1))
        cs.gate("rlp/hdr_class", qb * ph * (csq + cm + cl - 1))
        # header classification ranges (via materialized indicators)
        hs, hm = self.hs.query(), self.hm.query()
        cs.gate("rlp/hs_def", qb * (hs - ph * csq))
        cs.gate("rlp/hm_def", qb * (hm - ph * cm))
        cs.lookup("rlp/h_single", [hs * b], [self.t128.query()])
        cs.lookup("rlp/h_short", [hm * (b - 0x80)], [self.t56.query()])
        cs.gate("rlp/h_long", qb * ph * cl * (b - 0xB8) * (b - 0xB9))
        # is-zero helpers: z == [operand == 0] per state
        opL = b - 0x80  # short-string length (hdr rows)
        cs.gate("rlp/zL_def", qb * ph * cm * (z - 1 + opL * inv))
        cs.gate("rlp/zL_zero", qb * ph * cm * z * opL)
        cs.gate("rlp/zR_def", qb * pl * (z - 1 + (rem - 1) * inv))
        cs.gate("rlp/zR_zero", qb * pl * z * (rem - 1))
        cs.gate("rlp/zP_def", qb * pp * (z - 1 + (rem - 1) * inv))
        cs.gate("rlp/zP_zero", qb * pp * z * (rem - 1))
        # transitions
        pl1, pp1 = self.pl.query(1), self.pp.query(1)
        rem1, lacc1, ilen1 = (
            self.rem.query(1), self.lacc.query(1), self.ilen.query(1),
        )
        cs.gate("rlp/next_pl", qt * (pl1 - ph * cl - pl * (1 - z)))
        cs.gate(
            "rlp/next_pp",
            qt * (pp1 - ph * cm * (1 - z) - pl * z - pp * (1 - z)),
        )
        cs.gate(
            "rlp/next_rem",
            qt * (
                rem1
                - ph * (cl * (b - 0xB7) + cm * (1 - z) * opL)
                - pl * ((1 - z) * (rem - 1) + z * lacc)
                - pp * (1 - z) * (rem - 1)
            ),
        )
        b1 = self.byte.query(1)
        cs.gate("rlp/lacc_enter", qt * ph * cl * (lacc1 - b1))
        cs.gate(
            "rlp/lacc_chain", qt * pl * (1 - z) * (lacc1 - 256 * lacc - b1)
        )
        cs.gate("rlp/ilen_hdr", qb * ph * (ilen - csq - cm * opL))
        cs.gate("rlp/ilen_pay_m", qt * ph * cm * (1 - z) * (ilen1 - opL))
        cs.gate("rlp/ilen_pay_l", qt * pl * z * (ilen1 - lacc))
        cs.gate("rlp/ilen_keep", qt * pp * (1 - z) * (ilen1 - ilen))
        # item counter + calldata indicator (item 6)
        ph1 = self.ph.query(1)
        cs.gate("rlp/itm_incr", qt * (self.itm.query(1) - itm - ph1))
        cs.gate("rlp/i5_def", qb * (i5 - 1 + (itm - 6) * invI))
        cs.gate("rlp/i5_zero", qb * i5 * (itm - 6))
        cs.gate("rlp/txid_keep", qt * (self.txid.query(1) - txid))
        # body-length countdown from the outer header
        q0 = self.q_b0.query()
        cs.gate("rlp/b0_state", q0 * (ph - 1))
        cs.gate("rlp/b0_item", q0 * (itm - 1))
        cs.gate(
            "rlp/b0_len_s",
            self.q_b0s.query() * (brem - self.byte.query(-1) + 0xC0),
        )
        cs.gate("rlp/b0_len_l", self.q_b0l.query() * (brem - self.lacc.query(-1)))
        cs.gate("rlp/brem_decr", qt * (self.brem.query(1) - brem + 1))
        qe = self.q_elast.query()
        cs.gate("rlp/end_len", qe * (brem - 1))
        # the event must END exactly on an item boundary
        cmpl = ph * (csq + cm * z) + pp * z
        cs.gate("rlp/end_item", qe * (cmpl - 1))
        # outer header forms
        cs.lookup(
            "rlp/oh_short", [self.q_ohs.query() * (b - 0xC0)], [self.t56.query()]
        )
        cs.gate("rlp/oh_l1", self.q_ohl1.query() * (b - 0xF8))
        cs.gate("rlp/oh_l2", self.q_ohl2.query() * (b - 0xF9))
        cs.gate("rlp/oln0", self.q_oln0.query() * (lacc - b))
        cs.gate(
            "rlp/oln1",
            self.q_oln1.query() * (lacc - 256 * self.lacc.query(-1) - b),
        )
        # every event byte is a byte
        cs.lookup("rlp/byte_range", [self.q_all.query() * b], [byte_table.query()])
        # the calldata item's parsed length == the tx table's data_len
        look = self.look.query()
        cs.gate("rlp/look_def", qb * (look - cmpl * i5))
        cs.lookup(
            "rlp/tx_data_len", [look * txid, look * ilen], tx.table_exprs()
        )
        return self

    # -- witness ---------------------------------------------------------------

    @staticmethod
    def events(wb: WitnessBlock):
        """(tx_table_id, payload) for every legacy (type-0) signed tx."""
        from ..witness.sig import tx_sig_payload

        out = []
        for tx, gid in zip(wb.signed_txs, wb.signed_tx_ids):
            if tx.type != 0:
                continue
            try:
                out.append((gid, tx_sig_payload(tx)))
            except ValueError:
                continue
        return out

    def rows_for(self, wb: WitnessBlock) -> int:
        return sum(len(p) + 1 for _t, p in self.events(wb))

    def assign(self, cs, fixed, adv, n, wb: WitnessBlock, row0: int) -> int:
        # range tables
        for v in range(56):
            fixed[self.t56.index][v] = v
        for v in range(128):
            fixed[self.t128.index][v] = v
        r = row0
        for txid, payload in self.events(wb):
            r = self._assign_event(cs, fixed, adv, r, payload, txid)
        return r - row0

    def _assign_event(self, cs, fixed, adv, r, payload, txid) -> int:
        oh = payload[0]
        if not (0xC0 <= oh <= 0xF9):
            return r  # not a list payload (witness bug) — skip
        if oh <= 0xF7:
            nlb = 0
            blen = oh - 0xC0
        else:
            nlb = oh - 0xF7
            blen = int.from_bytes(payload[1 : 1 + nlb], "big")
        body = payload[1 + nlb :]
        assert len(body) == blen, "malformed rlp payload (witness bug)"

        def put(col, row, v):
            adv[col.index][row] = v

        # outer header row(s)
        fixed[self.q_all.index][r] = 1
        put(self.byte, r, oh)
        put(self.lacc, r, 0)
        if nlb == 0:
            fixed[self.q_ohs.index][r] = 1
        else:
            fixed[(self.q_ohl1 if nlb == 1 else self.q_ohl2).index][r] = 1
        r += 1
        lacc = 0
        for i in range(nlb):
            fixed[self.q_all.index][r] = 1
            put(self.byte, r, payload[1 + i])
            lacc = 256 * lacc + payload[1 + i]
            put(self.lacc, r, lacc)
            fixed[(self.q_oln0 if i == 0 else self.q_oln1).index][r] = 1
            r += 1

        # body state machine (host mirror of the gates)
        state = "hdr"
        rem = 0
        lacc = 0
        ilen = 0
        itm = 0
        first = True
        for bi, byte in enumerate(body):
            fixed[self.q_all.index][r] = 1
            fixed[self.q_body.index][r] = 1
            last = bi == len(body) - 1
            if not last:
                fixed[self.q_tr.index][r] = 1
            else:
                fixed[self.q_elast.index][r] = 1
            if first:
                fixed[self.q_b0.index][r] = 1
                fixed[(self.q_b0s if nlb == 0 else self.q_b0l).index][r] = 1
                first = False
            put(self.byte, r, byte)
            put(self.txid, r, txid)
            put(self.brem, r, len(body) - bi)
            ph = int(state == "hdr")
            pl = int(state == "len")
            pp = int(state == "pay")
            if ph:
                itm += 1
            put(self.ph, r, ph)
            put(self.pl, r, pl)
            put(self.pp, r, pp)
            put(self.itm, r, itm)
            d = itm - 6
            put(self.i5, r, int(d == 0))
            put(self.invI, r, pow(d, -1, FRM) if d else 0)
            csv = cmv = clv = 0
            if ph:
                if byte < 0x80:
                    csv = 1
                elif byte < 0xB8:
                    cmv = 1
                else:
                    clv = 1
                put(self.ilen, r, csv * 1 + cmv * (byte - 0x80))
                ilen = csv * 1 + cmv * (byte - 0x80)
            else:
                put(self.ilen, r, ilen)
            put(self.cs_, r, csv)
            put(self.cm, r, cmv)
            put(self.cl, r, clv)
            # z/inv per state
            if ph and cmv:
                op = byte - 0x80
            elif pl or pp:
                op = rem - 1
            else:
                op = 1  # unconstrained slot; keep nonzero
            zv = int(op == 0)
            put(self.z, r, zv)
            put(self.inv, r, pow(op, -1, FRM) if op % FRM else 0)
            put(self.rem, r, rem)
            # lookup indicator columns
            put(self.hs, r, ph * csv)
            put(self.hm, r, ph * cmv)
            cmpl = ph * (csv + cmv * zv) + pp * zv
            put(self.look, r, cmpl * int(d == 0))
            # next-state bookkeeping (mirrors the gates)
            if ph:
                if csv or (cmv and byte == 0x80):
                    state, rem = "hdr", 0
                elif cmv:
                    state, rem = "pay", byte - 0x80
                else:
                    state, rem, lacc = "len", byte - 0xB7, 0
                put(self.lacc, r, lacc)
            elif pl:
                lacc = 256 * lacc + byte
                put(self.lacc, r, lacc)
                if rem - 1 == 0:
                    state, rem = "pay", lacc
                    ilen = lacc
                else:
                    rem -= 1
            else:  # pay
                put(self.lacc, r, lacc)
                if rem - 1 == 0:
                    state, rem = "hdr", 0
                else:
                    rem -= 1
            r += 1
        return r
