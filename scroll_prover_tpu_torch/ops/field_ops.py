"""Modular arithmetic on limb-plane field elements, in PyTorch.

Field elements are int32 tensors of shape (..., 16) holding 16-bit limbs,
little-endian (fields/limbs.py): the JAX package's layout, so the tests
compare like with like.

Every elementwise field op is kernel K1 on the card (csrc/mont_mul.cu), one
launch per call, for Fr and for Fq with the modulus passed in: a CUDA tensor
goes through `mont_mul_k1` (the product modes: a*b, a*b + c, a*b - c) or
`add_sub_k1` (a + b, a - b, -a); a CPU tensor goes through the plain
versions: a Montgomery product over lazy int64 limb sums, carries moved in
whole rounds. On the card, where the plain versions are the kernels'
oracle, the same product walks its carry chains in order (a round's test
for a remaining carry would wait for the device): a few hundred small
launches per product and ~35 per add, where the prover calls them
thousands of times.

Every output is canonical (< p), so the kernel, the plain version and the JAX
package agree bit for bit whatever algorithm each uses inside.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.limbs import (
    LIMB_DTYPE, LIMB_MASK, N_LIMBS, LimbField, int_to_limbs, ints_to_limbs,
    limbs_from_torch, limbs_to_ints, limbs_to_torch,
)
from . import cuda_lib

_CONSTS: dict = {}


def _const(f: LimbField, name: str, device) -> torch.Tensor:
    """Per-field constant limb rows (p, R mod p, R^2 mod p, 1), cached per
    device."""
    key = (f.modulus, name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        vals = {"p": f.p_limbs, "r": f.r_limbs, "r2": f.r2_limbs, "one": int_to_limbs(1)}
        t = limbs_to_torch(vals[name], device)
        _CONSTS[key] = t
    return t


# --- raw limb add/sub with carry/borrow chains ------------------------------


def _carry(s: torch.Tensor):
    """Normalize lazy limbs (each of either sign, |limb| < 2^62) to 16 bits;
    returns (limbs, carry out of the top), the carry negative for a borrow.
    On the CPU every round moves each limb's carry up one position at once,
    until no limb carries (two rounds for a sum of two canonical values,
    more only where a carry runs through 0xFFFF limbs); on the card, where
    that test would wait for the device each round, one pass walks the
    limbs in order."""
    if s.is_cuda:
        return _carry_in_order(s)
    x = s.reshape(-1, s.shape[-1])
    top = torch.zeros_like(x[:, 0])
    while True:
        c = x >> 16  # floor: -1 for a borrow
        if not bool(c.any()):
            return x.reshape(s.shape), top.reshape(s.shape[:-1])
        x = x & LIMB_MASK
        x[:, 1:] += c[:, :-1]
        top += c[:, -1]


def _carry_in_order(s: torch.Tensor):
    """`_carry` as one pass over the limbs, low to high."""
    out = torch.empty_like(s)
    c = torch.zeros_like(s[..., 0])
    for j in range(s.shape[-1]):
        v = s[..., j] + c
        out[..., j] = v & LIMB_MASK
        c = v >> 16
    return out, c


def _sub_raw(a, b):
    """Limbwise a - b with borrow: (diff_limbs, borrow in {0, 1})."""
    d, c = _carry(a - b)
    return d, -c


def _cond_sub_p(f: LimbField, t, extra):
    """t - p if t + extra*2^256 >= p else t (assumes the value is < 2p)."""
    d, brw = _sub_raw(t, _const(f, "p", t.device))
    take = (extra > 0) | (brw == 0)
    return torch.where(take[..., None], d, t)


def _add_mod_plain(f: LimbField, a, b):
    """Plain K1as add: (a + b) mod p; inputs canonical."""
    s, c = _carry(a + b)
    return _cond_sub_p(f, s, c)


def _sub_mod_plain(f: LimbField, a, b):
    """Plain K1as sub: (a - b) mod p; inputs canonical."""
    d, brw = _sub_raw(a, b)
    dp, _ = _carry(d + _const(f, "p", d.device))
    return torch.where((brw > 0)[..., None], dp, d)


def _neg_mod_plain(f: LimbField, a):
    """Plain K1as neg: (-a) mod p; maps 0 -> 0."""
    d, _ = _sub_raw(_const(f, "p", a.device).expand_as(a), a)
    return torch.where(is_zero(a)[..., None], a, d)


def is_zero(a):
    return (a == 0).all(dim=-1)


def select(mask, a, b):
    """Elementwise select; mask has shape a.shape[:-1]."""
    return torch.where(mask[..., None], a, b)


# --- Montgomery multiplication ------------------------------------------------


def _diag_sums(x):
    """(N, 16, 16) products x[:, i, j] -> (N, 31): column c sums the
    products with i + j = c (each row padded by 16 zeros and read back at
    a stride of 31, which shears row i right by i)."""
    N, L, _ = x.shape
    y = torch.nn.functional.pad(x, (0, L)).reshape(N, 2 * L * L)
    return y[:, : L * (2 * L - 1)].reshape(N, L, 2 * L - 1).sum(1)


_TOEPLITZ: dict = {}


def _toeplitz(f: LimbField, name: str, device) -> torch.Tensor:
    """(16, cols) int64 t[i, c] = v[c - i] (0 outside v) for v = p (31
    columns: the full product's positions) or p' = -p^-1 mod R (16: the
    product mod R), so that (x[:, :, None] * t).sum(1) is x * v in lazy
    limbs."""
    key = (f.modulus, name, str(device))
    t = _TOEPLITZ.get(key)
    if t is None:
        v = f.modulus if name == "p" else -pow(f.modulus, -1, 1 << 256) % (1 << 256)
        cols = 2 * N_LIMBS - 1 if name == "p" else N_LIMBS
        limbs = [int(x) for x in int_to_limbs(v)]
        rows = [[limbs[c - i] if 0 <= c - i < N_LIMBS else 0 for c in range(cols)] for i in range(N_LIMBS)]
        t = _TOEPLITZ[key] = torch.tensor(rows, dtype=torch.int64, device=device)
    return t


# rows per step of the plain product, whose (rows, 16, 32) int64 products
# are 256 MiB on the CPU and 2 GiB on the card, where fewer, larger steps
# keep its ~170 launches a step from setting its time
_MUL_ROWS = 1 << 16
_MUL_ROWS_CUDA = 1 << 19


def _redc_rows(f: LimbField, a, b):
    """(N, 16) int64 limbs -> (N, 16) int32 a*b*R^-1 mod p, canonical,
    without an interleaved loop: T = a*b as lazy limb sums, m = T * p' mod R
    (p' = -p^-1 mod R) from T's low half, U = T + m*p; U / R = a*b*R^-1 is
    U's high half, below 2p, less p where it is not below p."""
    L = N_LIMBS
    t = _diag_sums(a[:, :, None] * b[:, None, :])  # T = a*b, limbs < 2^36
    m, _ = _carry((t[:, :L, None] * _toeplitz(f, "pinv", a.device)).sum(1))  # T * p' mod R
    u = t + (m[:, :, None] * _toeplitz(f, "p", a.device)).sum(1)  # U = T + m*p = 0 mod R, limbs < 2^37
    # U's low half is 0 mod R: three carry rounds leave its limbs at most
    # 2^16, where their value is 0 or R, so the carry into the high half is
    # what the rounds moved out plus one where a low limb is not 0 (its
    # carries would otherwise ripple through all 16 limbs, a round each)
    lo, hi = u[:, :L], torch.nn.functional.pad(u[:, L:], (0, 1))
    for _ in range(3):
        c = lo >> 16
        lo = lo & LIMB_MASK
        lo[:, 1:] += c[:, :-1]
        hi[:, 0] += c[:, -1]
    hi[:, 0] += (lo != 0).any(1).to(torch.int64)
    res, c = _carry(hi)  # U / R < 2p
    return _cond_sub_p(f, res.to(LIMB_DTYPE), c.to(LIMB_DTYPE))


def _mont_mul_plain(f: LimbField, a, b):
    """Plain PyTorch K1: the Montgomery product over 16-bit limbs in int64,
    `_redc_rows` over _MUL_ROWS rows at a time (_MUL_ROWS_CUDA on the card)."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a = a.reshape(-1, N_LIMBS).to(torch.int64)
    b = b.reshape(-1, N_LIMBS).to(torch.int64)
    out = torch.empty(a.shape, dtype=LIMB_DTYPE, device=a.device)
    rows = _MUL_ROWS_CUDA if a.is_cuda else _MUL_ROWS
    for s in range(0, a.shape[0], rows):
        out[s : s + rows] = _redc_rows(f, a[s : s + rows], b[s : s + rows])
    return out.reshape(shape)


def _mont_mul_add_plain(f: LimbField, a, b, c, sub: bool = False):
    """Plain K1 a*b + c (or a*b - c with sub)."""
    ab = _mont_mul_plain(f, a, b)
    return _sub_mod_plain(f, ab, c) if sub else _add_mod_plain(f, ab, c)


# --- K1: the elementwise field kernel ------------------------------------------

# modes of csrc/mont_mul.cu; the first three are the product (K1), the rest
# its neighbours without a product (K1as)
MUL, MUL_ADD, MUL_SUB, ADD, SUB, NEG = range(6)
MODE_NAMES = ("mul", "mul_add", "mul_sub", "add", "sub", "neg")


def _operand(x: torch.Tensor):
    """(tensor, element stride, limb stride) for K1's loads of a (..., 16)
    operand. The elements (every axis but the last, in order) must sit at one
    stride from one another: a contiguous tensor (16), a transposed view of
    a limb-major plane (1), a broadcast along every element axis (0, e.g. a
    scalar expanded over a column). Anything else is made contiguous."""
    ls = x.stride(-1)
    dims = [(s, st) for s, st in zip(x.shape[:-1], x.stride()[:-1]) if s != 1]
    if all(st == 0 for _, st in dims):
        return x, 0, ls
    es = expect = dims[-1][1]
    for size, st in reversed(dims):
        if st != expect:
            x = x.contiguous()
            return x, N_LIMBS, 1
        expect *= size
    return x, es, ls


def _k1_launch(f: LimbField, mode: int, ops):
    """One K1 launch of `mode` on the broadcast operands `ops` (1 to 3 int32
    CUDA tensors); returns a new contiguous tensor of their shape."""
    if not all(x.is_cuda for x in ops):
        raise ValueError("K1 takes CUDA tensors")
    if any(x.dtype != LIMB_DTYPE for x in ops):
        raise TypeError("limb tensors must be int32")
    ops = torch.broadcast_tensors(*ops)
    shape = ops[0].shape
    if shape[-1] != N_LIMBS:
        raise ValueError(f"bad limb layout {tuple(shape)}: (..., 16) limbs")
    n = ops[0].numel() // N_LIMBS
    out = torch.empty(shape, dtype=LIMB_DTYPE, device=ops[0].device)
    if n == 0:
        return out
    # the operands as the kernel reads them; the list keeps any contiguous
    # copy alive until the launch is queued
    held = [_operand(x) for x in (*ops, *(ops[0],) * (3 - len(ops)))]  # unused: a again
    args = [v for x, es, ls in held for v in (x.data_ptr(), es, ls)]
    rc = cuda_lib.lib("mont_mul").spt_field(
        mode, out.data_ptr(), *args, n,
        cuda_lib.field_params(f), cuda_lib.stream_ptr(out),
    )
    cuda_lib.check(rc, f"K1 {MODE_NAMES[mode]}")
    return out


def mont_mul_k1(f: LimbField, a, b, c=None, sub: bool = False):
    """K1 wrapper, product modes: a*b, or a*b + c (a*b - c with sub), on the
    card, for (..., 16) operands that broadcast.

    Replaces ops/ntt_tile.py `_mul_kernel` (called through `lm_mul`) of the JAX
    package. Launch count: `mont_mul_k1.launches`, by mode in
    `mont_mul_k1.by_mode`."""
    mode = MUL if c is None else MUL_SUB if sub else MUL_ADD
    out = _k1_launch(f, mode, (a, b) if c is None else (a, b, c))
    if out.numel():
        mont_mul_k1.launches += 1
        mont_mul_k1.by_mode[MODE_NAMES[mode]] += 1
    return out


mont_mul_k1.launches = 0
mont_mul_k1.by_mode = dict.fromkeys(MODE_NAMES[:3], 0)


def add_sub_k1(f: LimbField, mode: int, a, b=None):
    """K1 wrapper, modes without a product: a + b (ADD), a - b (SUB), -a
    (NEG), on the card.

    Replaces the JAX package's plain ops/field_ops.py `add_mod`, `sub_mod`
    and `neg_mod` (no Pallas kernel). Launch count: `add_sub_k1.launches`,
    by mode in `add_sub_k1.by_mode`."""
    if mode not in (ADD, SUB, NEG) or (b is None) != (mode == NEG):
        raise ValueError(f"add_sub_k1 takes ADD or SUB with two operands, NEG with one (mode {mode})")
    out = _k1_launch(f, mode, (a,) if b is None else (a, b))
    if out.numel():
        add_sub_k1.launches += 1
        add_sub_k1.by_mode[MODE_NAMES[mode]] += 1
    return out


add_sub_k1.launches = 0
add_sub_k1.by_mode = dict.fromkeys(MODE_NAMES[3:], 0)


def _on_card(*xs) -> bool:
    return any(x.is_cuda for x in xs)


def add_mod(f: LimbField, a, b):
    """(a + b) mod p; inputs canonical; broadcasts."""
    return add_sub_k1(f, ADD, a, b) if _on_card(a, b) else _add_mod_plain(f, a, b)


def sub_mod(f: LimbField, a, b):
    """(a - b) mod p; inputs canonical; broadcasts."""
    return add_sub_k1(f, SUB, a, b) if _on_card(a, b) else _sub_mod_plain(f, a, b)


def neg_mod(f: LimbField, a):
    """(-a) mod p; maps 0 -> 0."""
    return add_sub_k1(f, NEG, a) if a.is_cuda else _neg_mod_plain(f, a)


def mont_mul(f: LimbField, a, b):
    """Montgomery product a*b*R^-1 mod p, canonical; broadcasts."""
    return mont_mul_k1(f, a, b) if _on_card(a, b) else _mont_mul_plain(f, a, b)


def mont_mul_add(f: LimbField, a, b, c, sub: bool = False):
    """a*b + c (a*b - c with sub), Montgomery, canonical; broadcasts. One
    K1 launch on the card."""
    if _on_card(a, b, c):
        return mont_mul_k1(f, a, b, c=c, sub=sub)
    return _mont_mul_add_plain(f, a, b, c, sub)


# the JAX package routes huge Fr arrays through the tiled kernel here; K1
# takes any size, so the two names are one function
mont_mul_big = mont_mul


def to_mont(f: LimbField, a):
    """Standard form -> Montgomery form (a * R^2 * R^-1)."""
    return mont_mul(f, a, _const(f, "r2", a.device))


def from_mont(f: LimbField, a):
    """Montgomery form -> standard form (a * 1 * R^-1)."""
    return mont_mul(f, a, _const(f, "one", a.device))


def one_mont(f: LimbField, shape=(), *, device) -> torch.Tensor:
    """Montgomery 1 (= R mod p) broadcast to (*shape, 16) (a view)."""
    return _const(f, "r", device).expand(*shape, N_LIMBS)


# --- exponentiation / inversion ----------------------------------------------


def pow_mont(f: LimbField, a, e: int):
    """a^e (a in Montgomery form, small static exponent)."""
    assert 0 <= e < (1 << 24)
    if e == 0:
        return one_mont(f, a.shape[:-1], device=a.device).clone()
    acc = a
    for bit in bin(e)[3:]:
        acc = mont_mul(f, acc, acc)
        if bit == "1":
            acc = mont_mul(f, acc, a)
    return acc


def inv_mont(f: LimbField, a):
    """a^-1 in Montgomery form; inv(0) = 0. The callers invert a handful of
    elements (a batch product's total, an opening point), so this reads them
    back and inverts with host integers: (aR)^-1 R = R^2 / (aR). The result
    is the unique canonical value the JAX package's Fermat chain gives."""
    p = f.modulus
    r2 = (1 << 512) % p
    flat = limbs_from_torch(a.reshape(-1, N_LIMBS))
    inv = [pow(v, p - 2, p) * r2 % p for v in limbs_to_ints(flat)]
    return limbs_to_torch(ints_to_limbs(inv), a.device).reshape(a.shape)


def _scan_mul(f: LimbField, x, reverse: bool = False):
    """Inclusive prefix (or suffix) product along axis 0, Hillis-Steele:
    log2(n) rounds of one full-width product each."""
    if reverse:
        return _scan_mul(f, x.flip(0)).flip(0)
    x = x.clone()
    n, s = x.shape[0], 1
    while s < n:
        x[s:] = mont_mul(f, x[s:], x[:-s])
        s *= 2
    return x


def batch_inv_mont(f: LimbField, a):
    """Batched inversion of (n, 16) along axis 0; zeros map to zero.

    Montgomery's trick in log depth: inclusive prefix and suffix products,
    one inversion of the total, inv[i] = pre[i-1] * suf[i+1] / total."""
    assert a.dim() == 2, "batch_inv_mont expects (n, 16)"
    z = is_zero(a)
    ones = one_mont(f, a.shape[:-1], device=a.device)
    a_safe = select(z, ones, a)
    pref = _scan_mul(f, a_safe)
    suff = _scan_mul(f, a_safe, reverse=True)
    total_inv = inv_mont(f, pref[-1])
    one_row = ones[:1]
    pref_ex = torch.cat([one_row, pref[:-1]])
    suff_ex = torch.cat([suff[1:], one_row])
    invs = mont_mul(f, mont_mul(f, pref_ex, suff_ex), total_inv)
    return select(z, torch.zeros_like(a), invs)


def rand_elements(f: LimbField, rng: np.random.Generator, n: int) -> np.ndarray:
    """Host helper: n uniform field elements as (n, 16) uint32 (standard
    form, canonical)."""
    out = [int.from_bytes(rng.bytes(40), "little") % f.modulus for _ in range(n)]
    return ints_to_limbs(out)
