"""The algorithm-level work counts and peaks (benchlib/roofline.py)."""
import torch
from benchlib import roofline as rl


def test_ntt_work_on_known_shapes():
    # 2^3: 4 butterflies a level, 3 levels, no scale: 12 products a column
    by, mu = rl.ntt_work(1, 8, scaled=False, inverse=False)
    assert mu == 12 * rl.MULS_PER_MONT
    assert by == 32 * (2 * 8 + 4)
    # two columns of 2^20 with a coset scale: + n products a column, + the table
    by, mu = rl.ntt_work(2, 1 << 20, scaled=True, inverse=False)
    assert mu == 2 * ((1 << 19) * 20 + (1 << 20)) * rl.MULS_PER_MONT
    assert by == 32 * (2 * 2 * (1 << 20) + (1 << 19) + (1 << 20))
    # an inverse transform pays n^-1 even without a scale
    assert rl.ntt_work(1, 8, False, True)[1] == (12 + 8) * rl.MULS_PER_MONT


def test_least_seconds_is_the_larger_bound():
    assert rl.least_seconds(3.35e12, 0) == 1.0
    assert rl.least_seconds(0, rl.INT32_MULS_PER_S * 2) == 2.0
    # an NTT column of 2^18 is bound by its products (~38 us), not its bytes
    by, mu = rl.ntt_work(1, 1 << 18, False, False)
    assert mu / rl.INT32_MULS_PER_S > by / rl.HBM_BYTES_PER_S
    assert 3.8e-5 < rl.least_seconds(by, mu) < 3.9e-5


def test_msm_work_takes_the_cheapest_window():
    n = 1 << 16
    live = {c: n * -(-254 // c) for c in rl.WINDOWS}  # dense digits
    by, mu = rl.msm_work(n, live)
    best = min(rl.window_cost(c, live[c]) for c in rl.WINDOWS)
    assert mu == best * rl.MULS_PER_MONT
    assert by == n * 96 + 96
    # no live digit: only the buckets' reduction and the fold remain
    assert rl.msm_work(n, dict.fromkeys(rl.WINDOWS, 0))[1] < mu / 50


def test_live_digits_on_known_scalars():
    def limbs(v):
        return [(v >> (16 * i)) & 0xFFFF for i in range(16)]

    r = (1 << 254) - 1
    t = torch.tensor([limbs(0), limbs(1), limbs(1 << 13), limbs(r), limbs(3 << 100)], dtype=torch.int32)
    got = rl.live_digits(t, widths=(8, 13))
    # c = 8: 1 -> 1, 2^13 -> 1, 2^254 - 1 -> 32 windows, 3 << 100 -> 1 (bits 100, 101 in one window)
    assert got[8] == 1 + 1 + 32 + 1
    # c = 13: 2^13 sits in window 1; 254 bits of ones fill 20 windows; bits 100-101 straddle 91-103
    assert got[13] == 1 + 1 + 20 + 1


def test_idle_time_is_cut_at_the_spans():
    """A device gap that outlasts a span is shared among the spans it
    crosses, innermost first; the benchmark's own pauses are left out."""
    from types import SimpleNamespace

    from benchlib import tracing

    ms = 1_000_000
    trace = {"window_ns": (0, 100 * ms), "work": [("k", 0, 10 * ms), ("k", 60 * ms, 70 * ms)]}
    tracer = SimpleNamespace(spans=[("witness", 0, 0.0, 0.030), ("keygen", 0, 0.030, 0.065),
                                    ("msm", 0, 0.050, 0.055), ("prove", 0, 0.065, 0.100)],
                             tallies=[(0.080, 0.090)])
    got = dict(tracing.breakdown(trace, tracer, anchor=0.0)["idle_gaps"])
    want = {"bench.witness": 0.020, "bench.keygen": 0.025, "bench.msm": 0.005, "bench.prove": 0.020}
    assert got.keys() == want.keys()
    assert all(abs(got[k] - v) < 1e-9 for k, v in want.items())
