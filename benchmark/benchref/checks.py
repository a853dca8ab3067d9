"""The comparisons that decide `correct`, on plain integers.

Every check takes what the program produced (raw limbs copied from the
device, host points, instance cells) and what the benchmark itself made
(the seed's tau, the traces), and returns True when they agree exactly.
The port keeps field elements as (n, 16) 16-bit limbs; NTT inputs and
outputs are in Montgomery form (value * 2^256 mod r), MSM scalars in
standard form. The checks are linear in the data, so the Montgomery
factor is carried through as a constant and never divided out element by
element.
"""
from __future__ import annotations

import hashlib

from . import curve
from .field import MONT_R_INV, R, limbs_to_ints, omega
from .linear import Sums
from .keccak import keccak256


def tau_of(srs_seed: bytes) -> int:
    """The toxic scalar of the insecure test SRS made from `srs_seed`: the
    SRS's monomial basis is [tau^i] G1 and its Lagrange basis [L_i(tau)] G1.
    The benchmark makes the seed, so it knows tau, and every commitment
    C = sum_i s_i B_i is the single point [sum_i s_i b_i(tau)] G1."""
    return int.from_bytes(hashlib.sha512(srs_seed).digest(), "little") % R


def _ints(arr, rows) -> list[int]:
    return limbs_to_ints(arr[rows])


def judge(ntt_samples: list, msm_samples: list, tau: int, z: int, pool=None, parts: int = 1):
    """(NTT samples that disagree, MSM samples that disagree).

    NTT (one column of one call of the program's NTT entry: `inp` and `out`
    in Montgomery form, `scale` an optional table, all raw limbs).
    Forward: out_i = a(omega^i) with a_j = scale_j inp_j; a(z) by powers of z
    over the input against the polynomial through the outputs at z, by
    its Lagrange basis, so a wrong output anywhere changes one side.
    Inverse: out_j = scale_j c_j with c the coefficients of the polynomial p
    through the inputs (n^-1 included); p(omega^i) = inp_i at the sampled
    position i, read from all the outputs: sum_j (out_j / scale_j)
    omega^(ij). A geometric scale (a coset's powers) divides through the
    point; another is inverted element by element.

    MSM (one column of one commitment): the program's point against
    [sum_i s_i b_i(tau)] G1, b_i = tau^i over the monomial basis and
    L_i(tau) over the Lagrange basis of the basis's domain size."""
    import numpy as np

    first = Sums(parts)
    geo = {k: first.geometric(s["scale"]) for k, s in enumerate(ntt_samples)
           if s["inverse"] and s["scale"] is not None}
    geometric = first.run(pool)
    sums = Sums(parts)
    plans = []
    for k, s in enumerate(ntt_samples):
        n = s["n"]
        if not s["inverse"]:
            a = sums.powers(z, s["inp"]) if s["scale"] is None else sums.powers(z, s["scale"], s["inp"], "mul")
            lhs_r = 1 if s["scale"] is None else MONT_R_INV
            plans.append((a, lhs_r, sums.lagrange(z, n, s["out"]), 1))
            continue
        i = s["position"] % n
        x = pow(omega(n), i, R)
        (inp_i,) = _ints(s["inp"], slice(i, i + 1))
        if s["scale"] is None:
            plans.append((sums.powers(x, s["out"]), 1, None, inp_i))
        elif geometric[geo[k]]:
            s0, s1 = _ints(s["scale"], slice(0, 2))
            plans.append((sums.powers(x * s0 % R * pow(s1, -1, R) % R, s["out"]), 1, None,
                          s0 * inp_i % R * MONT_R_INV % R))
        else:
            plans.append((sums.powers(x, s["out"], s["scale"], "div"), 1, None, inp_i * MONT_R_INV % R))
    msm_plans = []
    for s in msm_samples:
        sc = np.asarray(s["scalars"])
        if s["basis"] == "monomial":
            msm_plans.append(sums.powers(tau, sc))
        elif s["basis"] == "lagrange":
            msm_plans.append(sums.lagrange(tau, s["basis_n"], sc))
        else:  # a basis the benchmark did not make
            msm_plans.append(None)
    res = sums.run(pool)
    ntt_bad = 0
    for a, scale, b, const in plans:
        lhs = res[a] * scale % R
        ntt_bad += lhs != (res[b] if b is not None else const)
    msm_bad = sum(p is None or curve.mul(curve.G1, res[p]) != s["point"] for p, s in zip(msm_plans, msm_samples))
    return ntt_bad, msm_bad


def _halves(h: str) -> tuple[int, int]:
    v = int(h, 16)
    return (v >> 128) % R, v & ((1 << 128) - 1)


def _hex(v) -> int:
    if isinstance(v, int):
        return v
    return int(v, 16) if isinstance(v, str) and v.startswith("0x") else int(v or 0)


def chunk_instance(traces: list[dict]) -> list[int]:
    """The chunk circuit's 9 public cells from its block traces (scroll's
    ChunkInfo): chain id, the state roots before and after and the
    withdraw root as (hi, lo) 128-bit halves, then the data hash
    keccak(block contexts || tx hashes) as (hi, lo). A block context is
    number (8 bytes), timestamp (8), base fee (32), gas limit (8), the
    number of transactions (2) and of L1 messages among them (2), big
    endian; a transaction without a 32-byte hash binds keccak(calldata)."""
    first, last = traces[0], traces[-1]
    contexts, hashes = b"", b""
    for t in traces:
        h = t.get("header") or {}
        txs = t.get("transactions") or []
        n_l1 = sum(1 for tx in txs if _hex(tx.get("type", 0)) == 0x7E)
        contexts += (_hex(h.get("number")).to_bytes(8, "big") + _hex(h.get("timestamp")).to_bytes(8, "big")
                     + (_hex(h.get("baseFeePerGas")) % (1 << 256)).to_bytes(32, "big")
                     + (_hex(h.get("gasLimit")) % (1 << 64)).to_bytes(8, "big")
                     + len(txs).to_bytes(2, "big") + n_l1.to_bytes(2, "big"))
        for tx in txs:
            th = tx.get("txHash", "")
            if th.startswith("0x") and len(th) == 66:
                hashes += bytes.fromhex(th[2:])
            else:
                data = tx.get("data", "0x")
                hashes += keccak256(bytes.fromhex(data[2:]) if data.startswith("0x") else b"")
    st0 = first.get("storageTrace") or {}
    st1 = last.get("storageTrace") or {}
    zero = "0x" + "00" * 32
    dh = int.from_bytes(keccak256(contexts + hashes), "big")
    return [_hex(first.get("chainID")) % R, *_halves(st0.get("rootBefore", zero)),
            *_halves(st1.get("rootAfter", zero)), *_halves(last.get("withdraw_trie_root", zero)),
            dh >> 128, dh & ((1 << 128) - 1)]
