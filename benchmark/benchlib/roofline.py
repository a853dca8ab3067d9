"""Published H100 peaks and the algorithm-level work of the port's NTT and
MSM calls, counted from the calls' shapes and scalars, whatever kernels
implement them. Taken from chip_smoke.py (`HBM_BYTES_PER_S`,
`INT32_OPS_PER_S`, `MULS_PER_MONT`, `work()`), which counts per CUDA
kernel; here the count is per transform and per commit.

Least time = max(bytes / HBM rate, 32-bit multiplies / int32 rate). A
field element is 32 bytes (254 bits), read or written once; a Montgomery
product over 8 32-bit words is 2 * (8*8 + 8*8 + 8) 32-bit multiply
instructions (a*b, m*p and m, each 32x32 -> 64-bit product two).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet, at 700 W
# int32 lanes are half the fp32 lanes (67 TFLOP/s fp32 = 33.5 T FMA/s)
INT32_MULS_PER_S = 33.5e12 / 2
MULS_PER_MONT = 2 * (8 * 8 + 8 * 8 + 8)
ELEMENT_BYTES = 32
POINT_BYTES = 2 * ELEMENT_BYTES  # affine G1
RESULT_BYTES = 3 * ELEMENT_BYTES  # projective G1
SCALAR_BITS = 254
# products per point operation: mixed (affine + Jacobian) add, Jacobian
# add, doubling (as chip_smoke.py's K3/K4 counts)
MIXED_ADD, ADD, DOUBLE = 11, 12, 8
WINDOWS = range(8, 21)  # bucket widths the MSM count minimises over


def least_seconds(bytes_moved: float, muls: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, muls / INT32_MULS_PER_S)


def ntt_work(columns: int, n: int, scaled: bool, inverse: bool) -> tuple[float, float]:
    """(bytes, 32-bit multiplies) of `columns` radix-2 transforms of size
    n: n/2 log2 n butterfly products a column, plus n for the element-wise
    scale or n^-1 (folded into one table when both); each element read and
    written once, the n/2 twiddles and the scale table read once."""
    log_n = n.bit_length() - 1
    products = columns * (n // 2 * log_n + (n if scaled or inverse else 0))
    table = n // 2 + (n if scaled else 0)
    return float(ELEMENT_BYTES * (2 * columns * n + table)), float(products * MULS_PER_MONT)


def window_cost(c: int, live: int) -> int:
    """Products of one bucket MSM column at window width c with `live`
    non-zero digits: one mixed add a live digit, the running-sum reduction
    of the 2^(c-1) signed buckets of each window (two adds a bucket), and
    the fold of the windows (an add and c doublings each)."""
    windows = -(-SCALAR_BITS // c)
    return live * MIXED_ADD + windows * 2 * (1 << (c - 1)) * ADD + (windows - 1) * (ADD + c * DOUBLE)


def msm_work(n: int, live_by_window: dict[int, int]) -> tuple[float, float]:
    """(bytes, 32-bit multiplies) of one MSM column of n points: each point
    and scalar read once, the result written once, at the window width
    that needs the fewest products for these scalars."""
    products = min(window_cost(c, live) for c, live in live_by_window.items())
    return float(n * (POINT_BYTES + ELEMENT_BYTES) + RESULT_BYTES), float(products * MULS_PER_MONT)


def live_digits(scalar_limbs, widths=WINDOWS, block: int = 1 << 18) -> dict[int, int]:
    """{c: non-zero c-bit digits} of the scalars, (n, 16) 16-bit limbs in
    standard form (a torch tensor, counted where it lies, `block` rows at a
    time)."""
    import torch

    dev = scalar_limbs.device
    totals = {c: torch.zeros((), dtype=torch.int64, device=dev) for c in widths}
    plans = {}
    for c in widths:
        starts = torch.arange(0, SCALAR_BITS, c, device=dev)
        plans[c] = (starts // 16, starts % 16, (1 << c) - 1)
    for lo in range(0, scalar_limbs.shape[0], block):
        part = scalar_limbs[lo:lo + block].to(torch.int64)
        limbs = torch.cat([part, torch.zeros((part.shape[0], 3), dtype=torch.int64, device=dev)], dim=1)
        for c, (li, off, mask) in plans.items():
            v = limbs[:, li] | (limbs[:, li + 1] << 16) | (limbs[:, li + 2] << 32)
            totals[c] += torch.count_nonzero((v >> off) & mask)
    return {c: int(t) for c, t in totals.items()}
