"""Minimal EVM interpreter (the revm `deploy_and_call` role).

Executes deployment bytecode (constructor returns runtime code), then calls
the runtime with calldata, metering gas loosely. Supports the opcode subset
a PLONK verifier contract uses plus the BN254 precompiles (ecAdd 0x06,
ecMul 0x07, pairing 0x08 — implemented over curves/), sha256 (0x02),
identity (0x04) and modexp (0x05).

Mirrors `prover::deploy_and_call(bytecode, calldata) -> Result<gas>`
(reference integration/src/verifier.rs:19, unit_tests.rs:48-54).
"""
from __future__ import annotations

from ..curves.bn254_curve import G1
from ..curves import pairing as pr
from ..fields.bn254 import FQ_MOD, FR_MOD
from ..hashes.keccak import keccak256

U256 = 1 << 256
MASK = U256 - 1


class EvmRevert(Exception):
    def __init__(self, data: bytes = b""):
        self.data = data
        super().__init__(f"revert: 0x{data.hex()}")


class _Memory(bytearray):
    def load(self, off: int, size: int) -> bytes:
        if size == 0:
            return b""
        if len(self) < off + size:
            self.extend(b"\x00" * (off + size - len(self)))
        return bytes(self[off : off + size])

    def store(self, off: int, data: bytes):
        if len(self) < off + len(data):
            self.extend(b"\x00" * (off + len(data) - len(self)))
        self[off : off + len(data)] = data


def _sgn(x: int) -> int:
    return x - U256 if x >> 255 else x


class EVM:
    """One-contract EVM: execute code with calldata, return output."""

    def __init__(self, gas_limit: int = 100_000_000):
        self.gas_limit = gas_limit
        self.gas_used = 0

    def execute(self, code: bytes, calldata: bytes) -> bytes:
        st: list[int] = []
        mem = _Memory()
        pc = 0
        ret = b""
        jumpdests = _jumpdests(code)
        push = st.append

        def pop():
            return st.pop()

        while pc < len(code):
            op = code[pc]
            self.gas_used += 3
            if self.gas_used > self.gas_limit:
                raise EvmRevert(b"out of gas")
            pc += 1
            if 0x60 <= op <= 0x7F:  # PUSH1..PUSH32
                n = op - 0x5F
                push(int.from_bytes(code[pc : pc + n], "big"))
                pc += n
            elif 0x80 <= op <= 0x8F:  # DUP
                push(st[-(op - 0x7F)])
            elif 0x90 <= op <= 0x9F:  # SWAP
                i = op - 0x8F
                st[-1], st[-1 - i] = st[-1 - i], st[-1]
            elif op == 0x01:
                push((pop() + pop()) & MASK)
            elif op == 0x02:
                push((pop() * pop()) & MASK)
            elif op == 0x03:
                a, b = pop(), pop()
                push((a - b) & MASK)
            elif op == 0x04:
                a, b = pop(), pop()
                push(a // b if b else 0)
            elif op == 0x05:  # SDIV
                a, b = _sgn(pop()), _sgn(pop())
                push((abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)) & MASK if b else 0)
            elif op == 0x06:
                a, b = pop(), pop()
                push(a % b if b else 0)
            elif op == 0x07:  # SMOD
                a, b = _sgn(pop()), _sgn(pop())
                push((abs(a) % abs(b) * (1 if a >= 0 else -1)) & MASK if b else 0)
            elif op == 0x08:
                a, b, m = pop(), pop(), pop()
                push((a + b) % m if m else 0)
            elif op == 0x09:
                a, b, m = pop(), pop(), pop()
                push((a * b) % m if m else 0)
            elif op == 0x0A:
                a, e = pop(), pop()
                push(pow(a, e, U256))
            elif op == 0x10:
                push(1 if pop() < pop() else 0)
            elif op == 0x11:
                push(1 if pop() > pop() else 0)
            elif op == 0x12:
                push(1 if _sgn(pop()) < _sgn(pop()) else 0)
            elif op == 0x13:
                push(1 if _sgn(pop()) > _sgn(pop()) else 0)
            elif op == 0x14:
                push(1 if pop() == pop() else 0)
            elif op == 0x15:
                push(1 if pop() == 0 else 0)
            elif op == 0x16:
                push(pop() & pop())
            elif op == 0x17:
                push(pop() | pop())
            elif op == 0x18:
                push(pop() ^ pop())
            elif op == 0x19:
                push((~pop()) & MASK)
            elif op == 0x1A:  # BYTE
                i, x = pop(), pop()
                push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:  # SHL
                s, v = pop(), pop()
                push((v << s) & MASK if s < 256 else 0)
            elif op == 0x1C:  # SHR
                s, v = pop(), pop()
                push(v >> s if s < 256 else 0)
            elif op == 0x20:  # SHA3
                off, size = pop(), pop()
                self.gas_used += 30 + 6 * ((size + 31) // 32)
                push(int.from_bytes(keccak256(mem.load(off, size)), "big"))
            elif op == 0x34:  # CALLVALUE
                push(0)
            elif op == 0x35:  # CALLDATALOAD
                off = pop()
                push(int.from_bytes((calldata[off : off + 32] + b"\x00" * 32)[:32], "big"))
            elif op == 0x36:
                push(len(calldata))
            elif op == 0x37:  # CALLDATACOPY
                d, s, n = pop(), pop(), pop()
                mem.store(d, (calldata[s : s + n] + b"\x00" * n)[:n])
            elif op == 0x38:
                push(len(code))
            elif op == 0x39:  # CODECOPY
                d, s, n = pop(), pop(), pop()
                mem.store(d, (code[s : s + n] + b"\x00" * n)[:n])
            elif op == 0x3D:
                push(len(ret))
            elif op == 0x3E:  # RETURNDATACOPY
                d, s, n = pop(), pop(), pop()
                mem.store(d, (ret[s : s + n] + b"\x00" * n)[:n])
            elif op == 0x50:
                pop()
            elif op == 0x51:
                push(int.from_bytes(mem.load(pop(), 32), "big"))
            elif op == 0x52:
                off, val = pop(), pop()
                mem.store(off, val.to_bytes(32, "big"))
            elif op == 0x53:
                off, val = pop(), pop()
                mem.store(off, bytes([val & 0xFF]))
            elif op == 0x56:  # JUMP
                dest = pop()
                if dest not in jumpdests:
                    raise EvmRevert(b"bad jump")
                pc = dest
            elif op == 0x57:  # JUMPI
                dest, cond = pop(), pop()
                if cond:
                    if dest not in jumpdests:
                        raise EvmRevert(b"bad jump")
                    pc = dest
            elif op == 0x58:
                push(pc - 1)
            elif op == 0x59:
                push(len(mem))
            elif op == 0x5A:  # GAS
                push(self.gas_limit - self.gas_used)
            elif op == 0x5B:  # JUMPDEST
                pass
            elif op == 0x5F:  # PUSH0
                push(0)
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                return mem.load(off, size)
            elif op == 0xFA:  # STATICCALL
                _gas, addr, in_off, in_size, out_off, out_size = (
                    pop(), pop(), pop(), pop(), pop(), pop(),
                )
                ok, ret = self._precompile(addr, mem.load(in_off, in_size))
                mem.store(out_off, ret[:out_size].ljust(min(out_size, len(ret)), b"\x00"))
                push(1 if ok else 0)
            elif op == 0xFD:  # REVERT
                off, size = pop(), pop()
                raise EvmRevert(mem.load(off, size))
            elif op == 0x00:  # STOP
                return b""
            else:
                raise EvmRevert(f"unsupported opcode 0x{op:02x}".encode())
        return b""

    def _precompile(self, addr: int, data: bytes):
        try:
            if addr == 2:
                import hashlib

                self.gas_used += 60
                return True, hashlib.sha256(data).digest()
            if addr == 4:
                return True, data
            if addr == 5:  # modexp
                bl = int.from_bytes(data[0:32], "big")
                el = int.from_bytes(data[32:64], "big")
                ml = int.from_bytes(data[64:96], "big")
                rest = data[96:]
                b = int.from_bytes(rest[:bl], "big")
                e = int.from_bytes(rest[bl : bl + el], "big")
                m = int.from_bytes(rest[bl + el : bl + el + ml], "big")
                self.gas_used += 200
                return True, (pow(b, e, m) if m else 0).to_bytes(ml, "big")
            if addr == 6:  # ecAdd
                self.gas_used += 150
                p1 = _dec_pt(data[0:64])
                p2 = _dec_pt(data[64:128])
                return True, _enc_pt(G1.add(p1, p2))
            if addr == 7:  # ecMul
                self.gas_used += 6000
                p1 = _dec_pt(data[0:64])
                s = int.from_bytes(data[64:96], "big")
                return True, _enc_pt(G1.mul(p1, s))
            if addr == 8:  # pairing
                self.gas_used += 45000 + 34000 * (len(data) // 192)
                pairs = []
                for i in range(0, len(data), 192):
                    g1 = _dec_pt(data[i : i + 64])
                    x1 = int.from_bytes(data[i + 64 : i + 96], "big")
                    x0 = int.from_bytes(data[i + 96 : i + 128], "big")
                    y1 = int.from_bytes(data[i + 128 : i + 160], "big")
                    y0 = int.from_bytes(data[i + 160 : i + 192], "big")
                    g2 = ((x0, x1), (y0, y1))
                    if g1 is not None and g2 != ((0, 0), (0, 0)):
                        pairs.append((g1, g2))
                ok = pr.pairing_check(pairs)
                return True, (1 if ok else 0).to_bytes(32, "big")
        except Exception:
            return False, b""
        return False, b""


def _dec_pt(b: bytes):
    x = int.from_bytes(b[:32], "big")
    y = int.from_bytes(b[32:64], "big")
    if x == 0 and y == 0:
        return None
    assert (y * y - x * x * x - 3) % FQ_MOD == 0, "not on curve"
    return (x, y)


def _enc_pt(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _jumpdests(code: bytes) -> set:
    out = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            out.add(i)
        i += (op - 0x5F + 1) if 0x60 <= op <= 0x7F else 1
    return out


def deploy_and_call(bytecode: bytes, calldata: bytes, gas_limit: int = 100_000_000) -> int:
    """Run deployment code -> runtime code, call it with calldata; returns
    gas used, raises EvmRevert on failure (reference verifier.rs:19)."""
    evm = EVM(gas_limit)
    runtime = evm.execute(bytecode, b"")
    if not runtime:
        raise EvmRevert(b"empty runtime code")
    evm.execute(runtime, calldata)
    return evm.gas_used
