"""Per-opcode EVM replay (the bus-mapping `CircuitInputBuilder` role).

Re-executes one transaction's bytecode from the trace's prestate and
cross-checks every step against the traced structLogs (pc/op/depth must
match exactly, and the final returnValue must match the trace). On success
it yields *real* per-opcode events that structLogs alone cannot provide —
EXP operands, SHA3 preimages, opcode-granular storage reads/writes, copy
bytes, exact stack/memory rw counts — upgrading the statistical witness
reduction in `witness/block.py` to a true replay (reference: bus-mapping
crate, SURVEY.md §2.2; VERDICT round-2 item 5 "real witness builder").

The structLog stream is the conformance oracle: JUMPI directions depend on
essentially every computed value, so a data error surfaces as a pc
mismatch within a few steps and the caller falls back to the statistical
path for that tx (honest degradation, never silent divergence).

Deliberately unmetered: gas is read from the structLogs (the GAS opcode
pushes `log.gas - log.gasCost`), exceptional halts (OOG &c.) are detected
by the traced depth dropping without RETURN/STOP/REVERT, and sub-frame
entry is confirmed by the traced depth rising — so no gas schedule is
needed for control-flow fidelity.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..hashes.keccak import keccak256
from ..l2types.block_trace import BlockTrace, ExecutionResult, TransactionTrace

U256 = 1 << 256
MASK = U256 - 1
MAX_MEM = 1 << 24  # 16 MiB guard; real traces cannot afford more gas


class ReplayDivergence(Exception):
    """Replay left the traced path (or hit an unsupported construct)."""


def _sgn(x: int) -> int:
    return x - U256 if x >> 255 else x


def _addr_int(a: str | None) -> int:
    if not a or not a.startswith("0x"):
        return 0
    try:
        return int(a, 16)
    except ValueError:
        return 0


def _hex_int(v) -> int:
    if v is None:
        return 0
    if isinstance(v, int):
        return v
    s = str(v)
    try:
        return int(s, 16) if s.startswith("0x") else int(s or "0")
    except ValueError:
        return 0


def _hex_bytes(v: str | None) -> bytes:
    if not v or not v.startswith("0x"):
        return b""
    try:
        return bytes.fromhex(v[2:])
    except ValueError:
        return b""


def _rlp_addr_nonce(addr: int, nonce: int) -> bytes:
    """rlp([address, nonce]) for CREATE address derivation."""
    a = addr.to_bytes(20, "big")
    n = b"" if nonce == 0 else nonce.to_bytes((nonce.bit_length() + 7) // 8, "big")
    if len(n) == 1 and n[0] < 0x80:
        enc_n = n
    else:
        enc_n = bytes([0x80 + len(n)]) + n
    items = b"\x94" + a + enc_n
    return bytes([0xC0 + len(items)]) + items


@dataclass
class Account:
    balance: int = 0
    nonce: int = 0
    code: bytes = b""
    storage: dict = field(default_factory=dict)


@dataclass
class StorageAccess:
    """One SLOAD/SSTORE/TLOAD/TSTORE with real operands."""

    addr: int
    slot: int
    value: int
    is_write: bool
    transient: bool = False


@dataclass
class CopyEvent:
    """Real bytes moved by a copy-family opcode."""

    kind: str  # CALLDATACOPY | CODECOPY | EXTCODECOPY | RETURNDATACOPY |
    #            MCOPY | RETURN | REVERT | LOGn | SHA3 | CALLDATA | CODE
    data: bytes


@dataclass
class ReplayResult:
    steps: int = 0
    # per traced step: keccak(frame code) when pc is inside the code (the
    # evm->bytecode lookup applies), 0 otherwise (implicit STOP padding)
    step_code_hashes: list = field(default_factory=list)
    step_op_bytes: list = field(default_factory=list)  # executed byte per step
    codes: dict = field(default_factory=dict)  # code hash -> executed bytes
    exp_events: list = field(default_factory=list)  # (base, exponent, result)
    sha3_events: list = field(default_factory=list)  # preimage bytes
    storage_accesses: list = field(default_factory=list)  # StorageAccess
    copy_events: list = field(default_factory=list)  # CopyEvent
    stack_rw: int = 0  # exact stack reads+writes
    memory_rw: int = 0  # exact memory word reads+writes
    # per traced step: frame call id, stack height BEFORE the op, and the
    # ordered stack accesses [(call_id, slot, value, is_write), ...] the op
    # performed — the evm circuit's semantic rw lookups consume these
    # (in-circuit opcode state-transition semantics, VERDICT round-3 #4)
    step_call_ids: list = field(default_factory=list)
    step_sp: list = field(default_factory=list)
    step_stack_ops: list = field(default_factory=list)
    # per traced step: executing frame's contract address and the ordered
    # storage accesses [(addr, slot, value, is_write, transient), ...] —
    # consumed by the evm circuit's SLOAD/SSTORE rw binding
    step_addrs: list = field(default_factory=list)
    step_store_ops: list = field(default_factory=list)
    # per traced step: 32-byte memory WORD accesses [(offset, word,
    # is_write), ...] for the evm circuit's MLOAD/MSTORE word binding
    step_mem_ops: list = field(default_factory=list)
    logs: int = 0
    return_data: bytes = b""
    failed: bool = False


class _Mem(bytearray):
    def load(self, off: int, size: int) -> bytes:
        if size == 0:
            return b""
        if off + size > MAX_MEM:
            raise ReplayDivergence("memory guard exceeded")
        if len(self) < off + size:
            self.extend(b"\x00" * (off + size - len(self)))
        return bytes(self[off : off + size])

    def store(self, off: int, data: bytes) -> None:
        if not data:
            return
        if off + len(data) > MAX_MEM:
            raise ReplayDivergence("memory guard exceeded")
        if len(self) < off + len(data):
            self.extend(b"\x00" * (off + len(data) - len(self)))
        self[off : off + len(data)] = data

    def msize(self) -> int:
        return (len(self) + 31) // 32 * 32


@dataclass
class _Frame:
    code: bytes
    calldata: bytes
    address: int  # storage/ADDRESS context
    code_address: int  # whose code runs (EXTCODE* of self unaffected)
    caller: int
    value: int
    static: bool
    is_create: bool = False
    pc: int = 0
    stack: list = field(default_factory=list)
    mem: _Mem = field(default_factory=_Mem)
    returndata: bytes = b""
    # (dest_stack_slot info for call return): set when a sub-call is pending
    pending_ret: tuple | None = None  # (out_off, out_size)
    chash: int = -1  # lazy keccak(code)
    call_id: int = 0  # unique frame id (stack rw rows group by it)

    def code_hash(self) -> int:
        if self.chash < 0:
            self.chash = int.from_bytes(keccak256(self.code), "big")
        return self.chash


class Replayer:
    _cur_ops: list = None
    _cur_store: list = None
    _cur_mem: list = None
    _next_cid: int = 0

    def _rec(self, call_id: int, slot: int, value: int, is_write: bool):
        if self._cur_ops is not None:
            self._cur_ops.append((call_id, slot, value & MASK, is_write))

    def _assign_cid(self, frame: "_Frame") -> "_Frame":
        self._next_cid += 1
        frame.call_id = self._next_cid
        return frame
    """Replays one tx against its structLog stream."""

    def __init__(self, trace: BlockTrace, tx: TransactionTrace,
                 er: ExecutionResult):
        self.trace = trace
        self.tx = tx
        self.er = er
        self.logs = er.struct_logs
        self.res = ReplayResult()
        self.world: dict[int, Account] = {}
        self.transient: dict[tuple, int] = {}
        self._seed_world(er.prestate)
        self._header = trace.header or {}

    # -- world ------------------------------------------------------------
    def _seed_world(self, prestate: dict) -> None:
        for addr_hex, acct in (prestate or {}).items():
            try:
                addr = int(addr_hex, 16)
            except (TypeError, ValueError):
                continue
            a = Account(
                balance=_hex_int(acct.get("balance")),
                nonce=_hex_int(acct.get("nonce")),
                code=_hex_bytes(acct.get("code")),
            )
            for k, v in (acct.get("storage") or {}).items():
                a.storage[_hex_int(k)] = _hex_int(v)
            self.world[addr] = a

    def _acct(self, addr: int) -> Account:
        return self.world.setdefault(addr, Account())

    # -- event emission ---------------------------------------------------
    def _sload(self, addr: int, slot: int, transient=False) -> int:
        store = self.transient if transient else self._acct(addr).storage
        key = (addr, slot) if transient else slot
        v = store.get(key, 0)
        self.res.storage_accesses.append(
            StorageAccess(addr, slot, v, False, transient)
        )
        if self._cur_store is not None:
            self._cur_store.append((addr, slot, v, False, transient))
        return v

    def _sstore(self, addr: int, slot: int, value: int, transient=False):
        if transient:
            self.transient[(addr, slot)] = value
        else:
            self._acct(addr).storage[slot] = value
        self.res.storage_accesses.append(
            StorageAccess(addr, slot, value, True, transient)
        )
        if self._cur_store is not None:
            self._cur_store.append((addr, slot, value, True, transient))

    # -- precompiles ------------------------------------------------------
    def _precompile(self, addr: int, data: bytes) -> bytes | None:
        """Output bytes, or None => unsupported (divergence)."""
        if addr == 1:  # ecrecover
            from ..curves import secp256k1

            if len(data) < 128:
                data = data + b"\x00" * (128 - len(data))
            z = int.from_bytes(data[:32], "big")
            v = int.from_bytes(data[32:64], "big")
            r = int.from_bytes(data[64:96], "big")
            s = int.from_bytes(data[96:128], "big")
            if v not in (27, 28):
                return b""
            q = secp256k1.ecrecover(z % secp256k1.N, v - 27, r, s)
            if q is None:
                return b""
            from .sig import pubkey_address

            return pubkey_address(q).to_bytes(32, "big")
        if addr == 2:
            return hashlib.sha256(data).digest()
        if addr == 3:
            try:
                h = hashlib.new("ripemd160", data).digest()
            except ValueError:
                return None
            return b"\x00" * 12 + h
        if addr == 4:
            return data
        if addr == 5:  # modexp
            if len(data) < 96:
                data = data + b"\x00" * (96 - len(data))
            bl = int.from_bytes(data[:32], "big")
            el = int.from_bytes(data[32:64], "big")
            ml = int.from_bytes(data[64:96], "big")
            if max(bl, el, ml) > 4096:
                return None
            rest = data[96:]
            b = int.from_bytes(rest[:bl].ljust(bl, b"\x00"), "big")
            e = int.from_bytes(rest[bl : bl + el].ljust(el, b"\x00"), "big")
            m = int.from_bytes(
                rest[bl + el : bl + el + ml].ljust(ml, b"\x00"), "big"
            )
            out = pow(b, e, m) if m else 0
            return out.to_bytes(ml, "big") if ml else b""
        if addr in (6, 7, 8):  # BN254: reuse the verifier-EVM precompiles
            from ..evm.interpreter import EVM

            ok, out = EVM()._precompile(addr, data.ljust(
                {6: 128, 7: 96, 8: max(len(data), 0)}[addr], b"\x00"))
            return out if ok else b""
        return None

    # -- main loop --------------------------------------------------------
    def run(self) -> ReplayResult:
        tx, er = self.tx, self.er
        sender = _addr_int(tx.from_addr)
        s_acct = self._acct(sender)
        # upfront: nonce bump + gas purchase + L1 data fee (Scroll)
        s_acct.nonce += 1
        s_acct.balance -= tx.gas * tx.gas_price + er.l1_data_fee
        code = _hex_bytes(er.byte_code)
        if tx.is_create or not tx.to_addr:
            created = int.from_bytes(
                keccak256(_rlp_addr_nonce(sender, s_acct.nonce - 1))[12:], "big"
            )
            frame = _Frame(
                code=code or tx.call_data, calldata=b"", address=created,
                code_address=created, caller=sender, value=tx.value,
                static=False, is_create=True,
            )
            self._acct(created).balance += tx.value
            s_acct.balance -= tx.value
        else:
            to = _addr_int(tx.to_addr)
            callee = self._acct(to)
            if not code:
                code = callee.code
            s_acct.balance -= tx.value
            callee.balance += tx.value
            frame = _Frame(
                code=code, calldata=tx.call_data, address=to,
                code_address=to, caller=sender, value=tx.value, static=False,
            )
        frames = [self._assign_cid(frame)]
        i = 0
        n = len(self.logs)
        while frames and i < n:
            f = frames[-1]
            log = self.logs[i]
            # exceptional halt(s): traced depth below current frame depth
            while len(frames) > log.depth:
                dead = frames.pop()
                self._frame_returned(frames, dead, b"", success=0)
            f = frames[-1]
            if len(frames) != log.depth:
                raise ReplayDivergence(
                    f"step {i}: depth {log.depth} vs frames {len(frames)}"
                )
            op = f.code[f.pc] if f.pc < len(f.code) else 0x00
            if f.pc != log.pc or _traced_byte(log.op) != op:
                raise ReplayDivergence(
                    f"step {i}: traced {log.op}@{log.pc} vs "
                    f"replayed {_BYTE_OP.get(op)}@{f.pc}"
                )
            i += 1
            self.res.steps += 1
            h = f.code_hash() if f.pc < len(f.code) else 0
            self.res.step_code_hashes.append(h)
            self.res.step_op_bytes.append(op)
            if h:
                self.res.codes.setdefault(h, f.code)
            self.res.step_call_ids.append(f.call_id)
            self.res.step_sp.append(len(f.stack))
            self._cur_ops = []
            self.res.step_stack_ops.append(self._cur_ops)
            self._cur_store = []
            self.res.step_store_ops.append(self._cur_store)
            self._cur_mem = []
            self.res.step_mem_ops.append(self._cur_mem)
            self.res.step_addrs.append(f.address)
            halt = self._step(frames, f, op, log)
            if halt is not None:
                data, success = halt
                dead = frames.pop()
                if not frames:
                    self.res.return_data = data
                    self.res.failed = success == 0
                    return self._finish(i)
                self._frame_returned(frames, dead, data, success)
        # trailing implicit halt (STOP beyond traced steps) or empty code
        while len(frames) > 1:
            dead = frames.pop()
            self._frame_returned(frames, dead, b"", success=1)
        return self._finish(i)

    def _finish(self, i: int) -> ReplayResult:
        if i < len(self.logs):
            raise ReplayDivergence(
                f"halted at step {i} with {len(self.logs) - i} traced steps left"
            )
        want = _hex_bytes(
            self.er.return_value
            if self.er.return_value.startswith("0x")
            else "0x" + self.er.return_value
        )
        if want and self.res.return_data != want:
            raise ReplayDivergence("returnValue mismatch")
        return self.res

    def _frame_returned(self, frames, dead: _Frame, data: bytes, success: int):
        parent = frames[-1]
        if dead.is_create:
            if success:
                self._acct(dead.address).code = data
                parent.stack.append(dead.address)
            else:
                parent.stack.append(0)
            self._rec(parent.call_id, len(parent.stack) - 1,
                      parent.stack[-1], True)
            parent.returndata = b"" if success else data
        else:
            parent.stack.append(success)
            self._rec(parent.call_id, len(parent.stack) - 1, success, True)
            parent.returndata = data
            if parent.pending_ret:
                out_off, out_size = parent.pending_ret
                if out_size:
                    parent.mem.store(out_off, data[:out_size])
        parent.pending_ret = None

    # -- one opcode -------------------------------------------------------
    def _step(self, frames, f: _Frame, op: int, log):
        st = f.stack
        push = st.append
        pop = st.pop
        res = self.res

        def spop(k=1):
            res.stack_rw += k
            if len(st) < k:
                raise ReplayDivergence("stack underflow")
            vals = []
            for _ in range(k):
                v = pop()
                self._rec(f.call_id, len(st), v, False)
                vals.append(v)
            return vals[0] if k == 1 else vals

        def spush(v):
            res.stack_rw += 1
            push(v & MASK)
            self._rec(f.call_id, len(st) - 1, v & MASK, True)

        f.pc += 1  # default; jumps overwrite
        if 0x60 <= op <= 0x7F:  # PUSH1..32
            nbytes = op - 0x5F
            data = f.code[f.pc : f.pc + nbytes].ljust(nbytes, b"\x00")
            spush(int.from_bytes(data, "big"))
            f.pc += nbytes
            return None
        if op == 0x5F:
            spush(0)
            return None
        if 0x80 <= op <= 0x8F:  # DUP
            k = op - 0x7F
            if len(st) < k:
                raise ReplayDivergence("stack underflow")
            res.stack_rw += 2
            v = st[-k]
            self._rec(f.call_id, len(st) - k, v, False)
            push(v)
            self._rec(f.call_id, len(st) - 1, v, True)
            return None
        if 0x90 <= op <= 0x9F:  # SWAP
            k = op - 0x8F
            if len(st) < k + 1:
                raise ReplayDivergence("stack underflow")
            res.stack_rw += 4
            a, b = st[-1], st[-k - 1]
            self._rec(f.call_id, len(st) - 1, a, False)
            self._rec(f.call_id, len(st) - 1 - k, b, False)
            st[-1], st[-k - 1] = b, a
            self._rec(f.call_id, len(st) - 1, b, True)
            self._rec(f.call_id, len(st) - 1 - k, a, True)
            return None
        if op == 0x50:
            spop()
            return None
        if op == 0x5B:  # JUMPDEST
            return None
        if op == 0x56:  # JUMP
            dest = spop()
            f.pc = dest
            return None
        if op == 0x57:  # JUMPI
            dest, cond = spop(), spop()
            if cond:
                f.pc = dest
            return None

        if op in _BINARY:
            a, b = spop(), spop()
            spush(_BINARY[op](a, b))
            return None
        if op in _UNARY:
            spush(_UNARY[op](spop()))
            return None
        if op == 0x08:  # ADDMOD
            a, b, m = spop(), spop(), spop()
            spush((a + b) % m if m else 0)
            return None
        if op == 0x09:  # MULMOD
            a, b, m = spop(), spop(), spop()
            spush((a * b) % m if m else 0)
            return None
        if op == 0x0A:  # EXP
            base, exp = spop(), spop()
            out = pow(base, exp, U256)
            res.exp_events.append((base, exp, out))
            spush(out)
            return None

        if op == 0x20:  # SHA3
            off, size = spop(), spop()
            data = f.mem.load(off, size)
            res.memory_rw += (size + 31) // 32
            res.sha3_events.append(data)
            res.copy_events.append(CopyEvent("SHA3", data))
            spush(int.from_bytes(keccak256(data), "big"))
            return None

        # environment
        if op == 0x30:
            spush(f.address)
            return None
        if op == 0x31:
            spush(self._acct(spop() & ((1 << 160) - 1)).balance)
            return None
        if op == 0x32:
            spush(_addr_int(self.tx.from_addr))
            return None
        if op == 0x33:
            spush(f.caller)
            return None
        if op == 0x34:
            spush(f.value)
            return None
        if op == 0x35:  # CALLDATALOAD
            off = spop()
            spush(int.from_bytes(f.calldata[off : off + 32].ljust(32, b"\x00"), "big"))
            return None
        if op == 0x36:
            spush(len(f.calldata))
            return None
        if op == 0x37:  # CALLDATACOPY
            doff, soff, size = spop(), spop(), spop()
            data = f.calldata[soff : soff + size].ljust(size, b"\x00") if size else b""
            f.mem.store(doff, data)
            res.memory_rw += (size + 31) // 32
            res.copy_events.append(CopyEvent("CALLDATACOPY", data))
            return None
        if op == 0x38:
            spush(len(f.code))
            return None
        if op == 0x39:  # CODECOPY
            doff, soff, size = spop(), spop(), spop()
            data = f.code[soff : soff + size].ljust(size, b"\x00") if size else b""
            f.mem.store(doff, data)
            res.memory_rw += (size + 31) // 32
            res.copy_events.append(CopyEvent("CODECOPY", data))
            return None
        if op == 0x3A:
            spush(self.tx.gas_price)
            return None
        if op == 0x3B:
            spush(len(self._acct(spop() & ((1 << 160) - 1)).code))
            return None
        if op == 0x3C:  # EXTCODECOPY
            addr, doff, soff, size = spop(), spop(), spop(), spop()
            code = self._acct(addr & ((1 << 160) - 1)).code
            data = code[soff : soff + size].ljust(size, b"\x00") if size else b""
            f.mem.store(doff, data)
            res.memory_rw += (size + 31) // 32
            res.copy_events.append(CopyEvent("EXTCODECOPY", data))
            return None
        if op == 0x3D:
            spush(len(f.returndata))
            return None
        if op == 0x3E:  # RETURNDATACOPY
            doff, soff, size = spop(), spop(), spop()
            if soff + size > len(f.returndata):
                raise ReplayDivergence("RETURNDATACOPY out of bounds")
            data = f.returndata[soff : soff + size]
            f.mem.store(doff, data)
            res.memory_rw += (size + 31) // 32
            res.copy_events.append(CopyEvent("RETURNDATACOPY", data))
            return None
        if op == 0x3F:  # EXTCODEHASH
            a = self._acct(spop() & ((1 << 160) - 1))
            if not a.code and a.balance == 0 and a.nonce == 0:
                spush(0)
            else:
                spush(int.from_bytes(keccak256(a.code), "big"))
            return None

        # block context
        if op == 0x40:
            spush(0)  # BLOCKHASH: unavailable; divergence surfaces via pc
            return None
        if op == 0x41:
            spush(_addr_int(self.trace.coinbase.address))
            return None
        if op == 0x42:
            spush(self.trace.timestamp)
            return None
        if op == 0x43:
            spush(self.trace.number)
            return None
        if op == 0x44:
            spush(_hex_int(self._header.get("mixHash")))
            return None
        if op == 0x45:
            spush(_hex_int(self._header.get("gasLimit")))
            return None
        if op == 0x46:
            spush(self.tx.chain_id or self.trace.chain_id)
            return None
        if op == 0x47:
            spush(self._acct(f.address).balance)
            return None
        if op == 0x48:
            spush(_hex_int(self._header.get("baseFeePerGas")))
            return None

        if op == 0x51:  # MLOAD
            off = spop()
            word = int.from_bytes(f.mem.load(off, 32), "big")
            spush(word)
            res.memory_rw += 1
            if self._cur_mem is not None:
                self._cur_mem.append((off, word, False))
            return None
        if op == 0x52:  # MSTORE
            off, v = spop(), spop()
            f.mem.store(off, v.to_bytes(32, "big"))
            res.memory_rw += 1
            if self._cur_mem is not None:
                self._cur_mem.append((off, v, True))
            return None
        if op == 0x53:  # MSTORE8
            off, v = spop(), spop()
            f.mem.store(off, bytes([v & 0xFF]))
            res.memory_rw += 1
            return None
        if op == 0x54:  # SLOAD
            spush(self._sload(f.address, spop()))
            return None
        if op == 0x55:  # SSTORE
            slot, v = spop(), spop()
            if f.static:
                raise ReplayDivergence("SSTORE in static context")
            self._sstore(f.address, slot, v)
            return None
        if op == 0x58:
            spush(log.pc)
            return None
        if op == 0x59:
            spush(f.mem.msize())
            return None
        if op == 0x5A:  # GAS: remaining after this op, from the trace
            spush(max(log.gas - log.gas_cost, 0))
            return None
        if op == 0x5C:  # TLOAD
            spush(self._sload(f.address, spop(), transient=True))
            return None
        if op == 0x5D:  # TSTORE
            slot, v = spop(), spop()
            self._sstore(f.address, slot, v, transient=True)
            return None
        if op == 0x5E:  # MCOPY
            doff, soff, size = spop(), spop(), spop()
            data = f.mem.load(soff, size)
            f.mem.store(doff, data)
            res.memory_rw += 2 * ((size + 31) // 32)
            res.copy_events.append(CopyEvent("MCOPY", data))
            return None

        if 0xA0 <= op <= 0xA4:  # LOG0..4
            topics = op - 0xA0
            off, size = spop(), spop()
            for _ in range(topics):
                spop()
            data = f.mem.load(off, size)
            res.memory_rw += (size + 31) // 32
            res.copy_events.append(CopyEvent(f"LOG{topics}", data))
            res.logs += 1
            return None

        if op in (0xF0, 0xF5):  # CREATE / CREATE2
            value, off, size = spop(), spop(), spop()
            salt = spop() if op == 0xF5 else None
            init = f.mem.load(off, size)
            res.memory_rw += (size + 31) // 32
            creator = self._acct(f.address)
            if salt is None:
                addr = int.from_bytes(
                    keccak256(_rlp_addr_nonce(f.address, creator.nonce))[12:],
                    "big",
                )
            else:
                pre = (
                    b"\xff"
                    + f.address.to_bytes(20, "big")
                    + salt.to_bytes(32, "big")
                    + keccak256(init)
                )
                addr = int.from_bytes(keccak256(pre)[12:], "big")
            creator.nonce += 1
            entered = self._entered_subframe(log)
            if not entered:
                # empty init code: account created immediately
                self._acct(addr).balance += value
                creator.balance -= value
                spush(addr)
                f.returndata = b""
                return None
            self._acct(addr).balance += value
            creator.balance -= value
            frames.append(
                self._assign_cid(_Frame(
                    code=init, calldata=b"", address=addr, code_address=addr,
                    caller=f.address, value=value, static=f.static,
                    is_create=True,
                ))
            )
            return None

        if op in (0xF1, 0xF2, 0xF4, 0xFA):  # CALL/CALLCODE/DELEGATECALL/STATICCALL
            if op in (0xF1, 0xF2):
                _gas, to, value, in_off, in_size, out_off, out_size = (
                    spop(), spop(), spop(), spop(), spop(), spop(), spop()
                )
            else:
                _gas, to, in_off, in_size, out_off, out_size = (
                    spop(), spop(), spop(), spop(), spop(), spop()
                )
                value = 0
            to &= (1 << 160) - 1
            data = f.mem.load(in_off, in_size)
            res.memory_rw += (in_size + 31) // 32
            res.copy_events.append(CopyEvent("CALLDATA", data))
            if 1 <= to <= 9:
                out = self._precompile(to, data)
                if out is None:
                    raise ReplayDivergence(f"unsupported precompile {to}")
                if op == 0xF1 and value:
                    self._acct(f.address).balance -= value
                    self._acct(to).balance += value
                f.returndata = out
                if out_size:
                    f.mem.store(out_off, out[:out_size])
                spush(1)
                return None
            callee = self._acct(to)
            entered = self._entered_subframe(log)
            if op == 0xF1 and value:
                self._acct(f.address).balance -= value
                callee.balance += value
            if not entered or not callee.code:
                f.returndata = b""
                spush(1)
                return None
            if op == 0xF1:  # CALL
                sub = _Frame(
                    code=callee.code, calldata=data, address=to,
                    code_address=to, caller=f.address, value=value,
                    static=f.static,
                )
            elif op == 0xF2:  # CALLCODE
                sub = _Frame(
                    code=callee.code, calldata=data, address=f.address,
                    code_address=to, caller=f.address, value=value,
                    static=f.static,
                )
            elif op == 0xF4:  # DELEGATECALL
                sub = _Frame(
                    code=callee.code, calldata=data, address=f.address,
                    code_address=to, caller=f.caller, value=f.value,
                    static=f.static,
                )
            else:  # STATICCALL
                sub = _Frame(
                    code=callee.code, calldata=data, address=to,
                    code_address=to, caller=f.address, value=0, static=True,
                )
            f.pending_ret = (out_off, out_size)
            frames.append(self._assign_cid(sub))
            return None

        if op == 0xF3:  # RETURN
            off, size = spop(), spop()
            data = f.mem.load(off, size)
            res.memory_rw += (size + 31) // 32
            res.copy_events.append(CopyEvent("RETURN", data))
            return (data, 1)
        if op == 0xFD:  # REVERT
            off, size = spop(), spop()
            data = f.mem.load(off, size)
            res.memory_rw += (size + 31) // 32
            res.copy_events.append(CopyEvent("REVERT", data))
            return (data, 0)
        if op == 0x00:  # STOP
            return (b"", 1)
        if op == 0xFF:  # SELFDESTRUCT
            to = spop() & ((1 << 160) - 1)
            a = self._acct(f.address)
            self._acct(to).balance += a.balance
            a.balance = 0
            return (b"", 1)
        if op == 0xFE:
            return (b"", 0)

        raise ReplayDivergence(f"unimplemented opcode 0x{op:02x} ({log.op})")

    def _entered_subframe(self, log) -> bool:
        """Did the traced stream enter a sub-frame after this step?"""
        idx = self.res.steps  # next unconsumed log index
        return idx < len(self.logs) and self.logs[idx].depth == log.depth + 1


_BINARY = {
    0x01: lambda a, b: a + b,
    0x02: lambda a, b: a * b,
    0x03: lambda a, b: a - b,
    0x04: lambda a, b: a // b if b else 0,
    0x05: lambda a, b: (
        0 if not b else (abs(_sgn(a)) // abs(_sgn(b)))
        * (1 if (_sgn(a) < 0) == (_sgn(b) < 0) else -1)
    ),
    0x06: lambda a, b: a % b if b else 0,
    0x07: lambda a, b: (
        0 if not b else (abs(_sgn(a)) % abs(_sgn(b))) * (1 if _sgn(a) >= 0 else -1)
    ),
    0x0B: lambda a, b: _signextend(a, b),
    0x10: lambda a, b: int(a < b),
    0x11: lambda a, b: int(a > b),
    0x12: lambda a, b: int(_sgn(a) < _sgn(b)),
    0x13: lambda a, b: int(_sgn(a) > _sgn(b)),
    0x14: lambda a, b: int(a == b),
    0x16: lambda a, b: a & b,
    0x17: lambda a, b: a | b,
    0x18: lambda a, b: a ^ b,
    0x1A: lambda a, b: (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0,
    0x1B: lambda a, b: b << a if a < 256 else 0,  # SHL(shift=a, value=b)
    0x1C: lambda a, b: b >> a if a < 256 else 0,
    0x1D: lambda a, b: (_sgn(b) >> a if a < 256 else (MASK if b >> 255 else 0)),
}
_UNARY = {
    0x15: lambda a: int(a == 0),
    0x19: lambda a: ~a,
}


def _signextend(k: int, v: int) -> int:
    if k >= 31:
        return v
    bit = 8 * (k + 1) - 1
    if v >> bit & 1:
        return v | (MASK ^ ((1 << (bit + 1)) - 1))
    return v & ((1 << (bit + 1)) - 1)


from ..zkevm.opcodes import OPCODE_BYTE

_BYTE_OP = {}
for _name, _b in OPCODE_BYTE.items():
    _BYTE_OP.setdefault(_b, _name)
_BYTE_OP[0x44] = "DIFFICULTY"  # l2geth traces the pre-merge mnemonic
_BYTE_OP[0x20] = "SHA3"


def _traced_byte(op_name: str) -> int:
    """Opcode byte for a traced mnemonic. Old l2geth tracers emit
    'opcode 0xNN not defined' for bytes missing from their string table
    (e.g. BASEFEE/MCOPY on older forks) while the VM executes them."""
    b = OPCODE_BYTE.get(op_name, -1)
    if b < 0 and op_name.startswith("opcode 0x"):
        try:
            return int(op_name.split()[1], 16)
        except (ValueError, IndexError):
            return -1
    return b


def replay_tx(trace: BlockTrace, tx: TransactionTrace,
              er: ExecutionResult) -> ReplayResult:
    """Replay one tx; raises ReplayDivergence when the traced path cannot
    be reproduced (caller falls back to the statistical witness path)."""
    if not er.struct_logs and not er.byte_code:
        # plain value transfer / empty-account call: nothing to replay
        return ReplayResult()
    return Replayer(trace, tx, er).run()
