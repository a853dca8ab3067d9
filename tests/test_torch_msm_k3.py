"""Port parity for K3's order contract: the plain bucket sort and per-slot
accumulation (K3's plain version), reduced by plain K4 and folded on the
host, against host Pippenger; its raw per-slot table against a naive
point-by-point walk; the packed affine table against the JAX package's point
prep. Exact equality throughout (integer arithmetic)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.ops import msm_tile as jmt
from scroll_prover_tpu_torch.curves.bn254_curve import host_msm_jac
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.fields.limbs import (
    FQ_LIMB, ints_to_limbs, limbs_from_torch, limbs_to_torch, limbs_to_words, words_to_limbs,
)
from scroll_prover_tpu_torch.ops import ec as tec
from scroll_prover_tpu_torch.ops import field_ops as tfo
from scroll_prover_tpu_torch.ops import msm_tile as tmt

torch.set_num_threads(2)

N = 301


@pytest.fixture(scope="module")
def points():
    """N distinct affine points, host ints and (N, 2, 16) Montgomery."""
    from scroll_prover_tpu_torch.proof_system.kzg import _batch_base_mul

    rng = np.random.default_rng(50)
    pts = _batch_base_mul([int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(N)])
    return pts, tec.encode_affine_mont(pts)


@pytest.fixture
def few_points_per_slot(monkeypatch):
    """S = 8 slots per bucket run at N = 301, so a slot holds about one point
    and most runs split unevenly (the card's 2^20-point columns deal each
    ~2^15-point run to 64 slots)."""
    monkeypatch.setattr(tmt, "K3_MIN_POINTS", 32)
    assert tmt._slots(N) == 8


def _column(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return [0] * n
    if kind == "small":  # few distinct digits: most buckets reached by no point
        return [int(v) for v in rng.choice([0, 1, 2, 3, 65, 2 * 64 + 5], size=n)]
    s = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]
    s[0], s[1] = 0, FR_MOD - 1
    return s


@pytest.mark.parametrize(
    "case",
    [
        "unequal_columns_cw129",  # 3 columns of 301, 260, 200 scalars: CW = 129 > 43 in one call
        "zero_column",            # an all-zero column folds to the identity (None)
        "unreached_buckets",      # scalars with few distinct digits
    ],
)
def test_k3_plain_folds_to_host_pippenger(points, few_points_per_slot, case):
    """Plain K3 (S = 8 slots) + plain K4 + host fold == host_msm_jac, column
    by column."""
    pts, enc = points
    cols = {
        "unequal_columns_cw129": [_column("rand", N, 1), _column("rand", 260, 2), _column("rand", 200, 3)],
        "zero_column": [_column("rand", N, 4), _column("zero", N, 5)],
        "unreached_buckets": [_column("small", N, 6)],
    }[case]
    got = tmt.msm_v2_host_batch(limbs_to_torch(enc, "cpu"), [limbs_to_torch(ints_to_limbs(s), "cpu") for s in cols])
    want = [host_msm_jac(pts[: len(s)], s) for s in cols]
    assert got == want
    if case == "zero_column":
        assert got[1] is None


def test_k3_plain_raw_table_matches_naive_walk(points, few_points_per_slot):
    """The order contract, limb for limb: the j-th point (ascending index)
    of |digit| b goes to slot u = j mod 4S, each (cw, u, bucket) adds its
    points in ascending index, as a naive walk over single points does, and
    output slot s is (u_s + u_{s+2S}) + (u_{s+S} + u_{s+3S}); buckets no
    point reaches stay the identity (0, R, 0)."""
    _, enc = points
    n = 128  # S = 4 slots: about one point per (slot, bucket)
    assert tmt._slots(n) == 4
    sc = limbs_to_torch(ints_to_limbs(_column("rand", n, 7)), "cpu")
    digs, signs = tmt._msm_prep_digits(sc, tmt.MSM_C)
    digs, signs = digs[41:43], signs[41:43]  # two windows; the top one (4 bits) reaches few buckets
    pts = tmt._msm_pack_points(limbs_to_torch(enc[:n], "cpu"))
    got = tmt._accum_v2_plain(pts, digs, signs, 33)
    assert got.shape == (2, 4, 32, 3, 8)

    q = limbs_to_torch(enc[:n], "cpu")
    SF = 4 * tmt.K3_FOLD  # accumulating slots per run
    acc = [c.clone() for c in tec.identity((2, SF, 32), device="cpu")]
    for cw in range(2):
        seen = [0] * 33  # points of each |digit| so far
        for i in range(n):  # ascending point index
            d = int(digs[cw, i])
            if d == 0:
                continue
            u = seen[d] % SF
            seen[d] += 1
            qy = q[i, 1]
            if signs[cw, i]:
                qy = tfo.neg_mod(FQ_LIMB, qy)
            cur = tec.PointP(*(c[cw, u, d - 1] for c in acc))
            nxt = tec.madd(cur, q[i, 0], qy)
            for c, v in zip(acc, nxt):
                c[cw, u, d - 1] = v
    a = [tec.PointP(*(c[:, 4 * f : 4 * f + 4] for c in acc)) for f in range(4)]  # slot s + 4f
    want = tec.add(tec.add(a[0], a[2]), tec.add(a[1], a[3]))
    assert torch.equal(got, limbs_to_words(torch.stack(list(want), dim=3)))
    empty = (digs[:, None, :] != torch.arange(1, 33)[:, None]).all(-1)  # (2, 32): bucket unused in the window
    assert empty.any()
    one = limbs_to_words(tec.identity((), device="cpu").y)
    for cw, b in zip(*torch.nonzero(empty, as_tuple=True)):
        assert torch.equal(got[cw, :, b, 1], one.expand(4, 8))
        assert not got[cw, :, b, 0].any() and not got[cw, :, b, 2].any()


def test_packed_table_roundtrips_jax_point_prep(points):
    """K3's packed affine table (n, 2, 8) words holds the same limbs as the
    JAX package's (16, tiles, 8, 128) point planes, and unpacks back."""
    _, enc = points
    n = jmt.SUB_T * 128  # the JAX prep takes a lane multiple
    rng = np.random.default_rng(8)
    raw = np.concatenate([enc, rng.integers(0, 1 << 16, size=(n - N, 2, 16), dtype=np.uint32)])
    jx, jy = jmt._msm_prep_points(jnp.asarray(raw))
    pts = tmt._msm_pack_points(limbs_to_torch(raw, "cpu"))
    assert pts.shape == (n, 2, 8) and pts.is_contiguous()
    limbs = words_to_limbs(pts)
    np.testing.assert_array_equal(limbs_from_torch(limbs[:, 0]).T, np.asarray(jx).reshape(16, n))
    np.testing.assert_array_equal(limbs_from_torch(limbs[:, 1]).T, np.asarray(jy).reshape(16, n))
    words = pts.numpy().view(np.uint32)
    np.testing.assert_array_equal(words, (raw[..., 0::2] | (raw[..., 1::2] << 16)).astype(np.uint32))


def test_k3_slots():
    """S: a power of two <= 64 (K4 takes log2(S) <= 6 rounds), at least
    K3_MIN_POINTS column points per slot."""
    assert [tmt._slots(n) for n in (300, 2048, 4096, 1 << 16, (1 << 20) - 4096, 1 << 20)] == [1, 2, 4, 64, 64, 64]
