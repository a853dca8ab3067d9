"""Port parity for K4, the MSM's reduction from K3's per-slot buckets to one
projective point per column (ops/msm_tile.py `_msm_reduce_plain`, the plain
version of csrc/msm.cu's k4_slot_sums and k4_window_fold).

One `msm_v2_host_batch` call over five columns of N = 301 numpy-made points
and scalars, at S = 8 slots per bucket run, is shared by the cases: its
affine points equal host Pippenger, and the host fold of the bucket table
that the JAX package folds after its lane reduction (`_host_fold_mont`, the
port's copy and the JAX package's own) on the same slot table; its
projective words equal a walk on host integers in the kernel's order (the
slot tree, the two Hillis-Steele scans, the window fold with complete
doublings); its slot tree equals the same tree of the JAX lane kernel's
point add; and its host-int window fold equals the torch scans and fold
of ops/msm.py on the same window sums. The wrapper takes CPU tables to the
plain version only through `_msm_reduce`, and refuses malformed tables. Exact equality throughout:
these are integers."""
import numpy as np
import pytest
import torch

from scroll_prover_tpu.ops import msm_tile as jmt
from scroll_prover_tpu_torch.curves.bn254_curve import host_msm_jac
from scroll_prover_tpu_torch.fields.bn254 import FQ_MOD, FR_MOD
from scroll_prover_tpu_torch.fields.limbs import LIMB_DTYPE, ints_to_limbs, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import ec as tec
from scroll_prover_tpu_torch.ops import msm_tile as tmt

torch.set_num_threads(2)

N = 301
C_BITS = tmt.MSM_C
W, B = tmt._wb(C_BITS)
R_INV = pow(1 << 256, -1, FQ_MOD)


def _columns() -> dict[str, list[int]]:
    rng = np.random.default_rng(110)
    dense = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(N)]
    dense[0], dense[1] = 0, FR_MOD - 1
    one = [0] * N
    one[17] = int.from_bytes(rng.bytes(32), "little") % FR_MOD
    return {
        "dense": dense,
        "dense_short": [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(200)],
        "zero": [0] * N,  # the identity: Z = 0, no affine point
        "one_point": one,
        "small_digits": [int(v) for v in rng.choice([0, 1, 2, 3, 65, 2 * 64 + 5], size=N)],
    }


COLUMNS = _columns()
NAMES = list(COLUMNS)


@pytest.fixture(scope="module")
def reduced():
    """The points, and what one msm_v2_host_batch call over every column
    gave: its affine points, the slot table K3's plain version handed to
    `_msm_reduce_plain` and its (C, 3, 8) projective words (S = 8 slots,
    so most bucket runs split unevenly over the slots)."""
    from scroll_prover_tpu_torch.proof_system.kzg import _batch_base_mul

    rng = np.random.default_rng(111)
    pts = _batch_base_mul([int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(N)])
    seen = []
    plain = tmt._msm_reduce_plain

    def record(tbl):
        seen.append((tbl, plain(tbl)))
        return seen[-1][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmt, "K3_MIN_POINTS", 32)
        mp.setattr(tmt, "_msm_reduce_plain", record)
        assert tmt._slots(N) == 8
        got = tmt.msm_v2_host_batch(limbs_to_torch(tec.encode_affine_mont(pts), "cpu"),
                                    [limbs_to_torch(ints_to_limbs(s), "cpu") for s in COLUMNS.values()])
    assert len(seen) == 1  # a CPU table took the plain version, once
    tbl, red = seen[0]
    return {"pts": pts, "got": got, "tbl": tbl, "red": red}


@pytest.mark.parametrize("name", NAMES)
def test_msm_matches_host_pippenger(reduced, name):
    i = NAMES.index(name)
    s = COLUMNS[name]
    want = host_msm_jac(reduced["pts"][: len(s)], s)
    assert reduced["got"][i] == want
    assert (want is None) == (name == "zero")


@pytest.mark.parametrize("name", NAMES)
def test_reduction_matches_host_fold_of_bucket_table(reduced, name):
    """The same affine point as the host fold of the slot tree's bucket
    table, the port's `_host_fold_mont` and the JAX package's."""
    i = NAMES.index(name)
    tbl = reduced["tbl"]
    assert tbl.shape == (len(NAMES) * W, 8, B - 1, 3, 8) and reduced["red"].shape == (len(NAMES), 3, 8)
    table = limbs_from_torch(tmt._bucket_table(tmt._lane_reduce_plain(tbl[i * W:(i + 1) * W])))
    assert table.shape == (W, B, 3, 16)
    got = tmt._affine_columns(reduced["red"][i].numpy())[0]
    assert got == tmt._host_fold_mont(table, C_BITS) == jmt._host_fold_mont(table, C_BITS)


def test_slot_tree_equals_the_jax_kernels_point_add(reduced):
    """The slot tree, limb for limb, equals the halving tree run with the
    JAX package's lane-reduction kernel's own complete add (`_kl_padd`,
    the body of `_lane_reduce_kernel` and of its 8 -> 1 tail: slot s adds
    slot s + h) on the same table. The kernel itself, through
    `_lane_reduce_v2(interpret=True)`, takes over 10 minutes on a CPU for
    one 128-lane column of 99 buckets, so its add runs eagerly on jnp
    arrays."""
    import jax.numpy as jnp

    from scroll_prover_tpu.fields.limbs import FQ_LIMB as JFQ

    tbl = reduced["tbl"]
    CW, S, NB = tbl.shape[:3]
    want = limbs_from_torch(tmt.words_to_limbs(tmt._lane_reduce_plain(tbl)))[:, 0]  # (CW, NB, 3, 16)
    a = limbs_from_torch(tmt.words_to_limbs(tbl)).astype(np.uint32).transpose(3, 4, 1, 0, 2).reshape(3, 16, S, CW * NB)
    p = [jnp.uint32(v) for v in np.asarray(JFQ.p_limbs)]
    b3 = [jnp.uint32(v) for v in np.asarray(jmt._consts())[:, 1]]
    pt = [[jnp.asarray(a[c, limb]) for limb in range(16)] for c in range(3)]
    h = S // 2
    while h >= 1:
        pt = jmt._kl_padd(p, b3, *([v[:h] for v in c] for c in pt), *([v[h:2 * h] for v in c] for c in pt))
        h //= 2
    got = np.stack([np.stack([np.asarray(v)[0] for v in c]) for c in pt])  # (3, 16, CW * NB)
    assert np.array_equal(got.reshape(3, 16, CW, NB).transpose(2, 3, 0, 1), want)


def _add(a, b):
    """RCB15 alg. 7 on standard-form integers (ops/ec.py `add`)."""
    P = FQ_MOD
    (x1, y1, z1), (x2, y2, z2) = a, b
    t0, t1, t2 = x1 * x2 % P, y1 * y2 % P, z1 * z2 % P
    t3 = ((x1 + y1) * (x2 + y2) - t0 - t1) % P
    t4 = ((y1 + z1) * (y2 + z2) - t1 - t2) % P
    y3 = ((x1 + z1) * (x2 + z2) - t0 - t2) % P
    x3 = 3 * t0 % P
    t2 = 9 * t2 % P
    z3 = (t1 + t2) % P
    t1 = (t1 - t2) % P
    y3 = 9 * y3 % P
    return (t3 * t1 - t4 * y3) % P, (t1 * z3 + y3 * x3) % P, (t4 * z3 + t3 * x3) % P


def _dbl(a):
    """RCB15 alg. 9 on standard-form integers (ops/ec.py `double`)."""
    P = FQ_MOD
    x, y, z = a
    t0 = y * y % P
    z3 = 8 * t0 % P
    t1 = y * z % P
    t2 = 9 * z * z % P
    x3 = t2 * z3 % P
    y3 = (t0 + t2) % P
    z3 = t1 * z3 % P
    t0 = (t0 - 3 * t2) % P
    y3 = (t0 * y3 + x3) % P
    x3 = 2 * t0 * (x * y % P) % P
    return x3, y3, z3


def _ints(words: np.ndarray) -> list[int]:
    """(..., 8) Montgomery words -> standard-form integers."""
    flat = np.ascontiguousarray(words.reshape(-1, 8)).astype("<u4")
    return [int.from_bytes(row.tobytes(), "little") * R_INV % FQ_MOD for row in flat]


def test_reduction_follows_the_kernel_order(reduced):
    """The projective words, limb for limb, equal a walk on host integers
    in K4's order: per bucket the slot tree (slot s adds slot s + h, h =
    S/2, ..., 1), per window a suffix then a prefix Hillis-Steele scan over
    buckets 1..32 (lane b adds lane b + s, then lane b - s, for s = 1, 2,
    4, 8, 16) whose last lane is sum_b b * B_b, per column the fold from
    the most significant window down (6 complete doublings, then one
    complete add), starting from the identity (0, 1, 0)."""
    tbl = reduced["tbl"].numpy()
    CW, S = tbl.shape[:2]
    v = _ints(tbl)
    pt = [tuple(v[3 * i:3 * i + 3]) for i in range(len(v) // 3)]  # (cw, s, bucket) order
    wins = []
    for cw in range(CW):
        lanes = []
        for b in range(B - 1):
            slots = [pt[(cw * S + s) * (B - 1) + b] for s in range(S)]
            while len(slots) > 1:
                h = len(slots) // 2
                slots = [_add(slots[s], slots[s + h]) for s in range(h)]
            lanes.append(slots[0])
        for s in (1, 2, 4, 8, 16):
            lanes = [_add(lanes[b], lanes[b + s]) if b + s < 32 else lanes[b] for b in range(32)]
        for s in (1, 2, 4, 8, 16):
            lanes = [_add(lanes[b], lanes[b - s]) if b >= s else lanes[b] for b in range(32)]
        wins.append(lanes[31])
    want = []
    for c in range(CW // W):
        acc = (0, 1, 0)
        for w in range(W - 1, -1, -1):
            for _ in range(C_BITS):
                acc = _dbl(acc)
            acc = _add(acc, wins[c * W + w])
        want += list(acc)
    assert _ints(reduced["red"].numpy()) == want
    assert want[3 * NAMES.index("zero") + 2] == 0


@pytest.mark.parametrize("n_windows", [1, 3])
def test_host_window_fold_equals_the_torch_scans_and_fold(n_windows):
    """`_window_fold_host` (the plain version's window sums and fold on host
    ints) gives the words of ops/msm.py `_weighted_windows` then
    `_fold_windows`, the torch functions whose step order K4's second kernel
    follows, on seeded field elements (some lanes the identity), two
    columns on a batch axis."""
    from scroll_prover_tpu_torch.fields.limbs import limbs_to_words
    from scroll_prover_tpu_torch.ops.msm import _fold_windows, _weighted_windows

    rng = np.random.default_rng(112 + n_windows)
    C, NB = 2, B - 1
    vals = [int.from_bytes(rng.bytes(32), "little") % FQ_MOD for _ in range(C * n_windows * NB * 3)]
    for k in rng.choice(C * n_windows * NB, size=5, replace=False):
        vals[3 * k:3 * k + 3] = [0, 1, 0]
    R = (1 << 256) % FQ_MOD
    buf = b"".join((v * R % FQ_MOD).to_bytes(32, "little") for v in vals)
    sums = np.frombuffer(buf, dtype="<i4").reshape(C, n_windows, NB, 3, 8).copy()
    got = tmt._window_fold_host(sums, C_BITS)

    t = tmt._bucket_table(torch.from_numpy(sums).reshape(C * n_windows, 1, NB, 3, 8))
    win = _weighted_windows(tec.PointP(t[:, :, 0], t[:, :, 1], t[:, :, 2]))
    acc = _fold_windows(tec.PointP(*(a.reshape(C, n_windows, 16).transpose(0, 1) for a in win)), C_BITS)
    want = limbs_to_words(torch.stack([a.expand(C, 16) for a in acc], dim=1))
    assert got.dtype == np.int32 and np.array_equal(got, want.numpy())


def test_cpu_table_takes_the_plain_version(reduced, monkeypatch):
    """`_msm_reduce` sends a CPU table to the plain version (the fixture's
    call went there); the kernel's wrapper refuses a well-formed CPU table
    with no fallback."""
    monkeypatch.setattr(tmt, "_msm_reduce_plain", lambda tbl: "plain")
    assert tmt._msm_reduce(reduced["tbl"]) == "plain"
    with pytest.raises(ValueError, match="on the card"):
        tmt._msm_reduce_k4(reduced["tbl"])


@pytest.mark.parametrize(
    "shape, dtype",
    [
        ((W + 1, 8, B - 1, 3, 8), LIMB_DTYPE),   # not whole columns
        ((W, 6, B - 1, 3, 8), LIMB_DTYPE),       # slot count not a power of two
        ((W, 128, B - 1, 3, 8), LIMB_DTYPE),     # more slots than K3 gives
        ((W, 8, B, 3, 8), LIMB_DTYPE),           # 33 buckets: bucket 0 included
        ((W, 8, B - 1, 3, 16), LIMB_DTYPE),      # limbs, not words
        ((W, B - 1, 3, 8), LIMB_DTYPE),          # no slot axis
        ((W, 8, B - 1, 3, 8), torch.int64),
    ],
)
def test_kernel_wrapper_refuses_malformed_tables(shape, dtype):
    with pytest.raises(ValueError, match="K4|_msm_reduce_k4") as err:
        tmt._msm_reduce_k4(torch.zeros(shape, dtype=dtype))
    assert "on the card" not in str(err.value)
