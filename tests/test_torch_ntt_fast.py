"""Port parity: the staged limb-major NTT (plain K7/K8 on the CPU) against the
JAX package's EvaluationDomain and butterflies, exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.fields.limbs import FR_LIMB as JFR
from scroll_prover_tpu.ops import field_ops as jfo
from scroll_prover_tpu.ops.ntt import EvaluationDomain as JaxDomain
from scroll_prover_tpu.ops.ntt_fast import butterfly_t as jax_butterfly_t
from scroll_prover_tpu_torch.fields.limbs import FR_LIMB, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import field_ops as tfo
from scroll_prover_tpu_torch.ops import ntt_fast as tnf

torch.set_num_threads(2)


def _mont(n, seed):
    return tfo.rand_elements(FR_LIMB, np.random.default_rng(seed), n)


_JAX_NTT = {}


def _jax_ntt(k):
    """EvaluationDomain(k).ntt of the test's input at 2^k, once per k."""
    if k not in _JAX_NTT:
        x = _mont(1 << k, 80 + k)
        _JAX_NTT[k] = x, np.asarray(JaxDomain(k).ntt(jnp.asarray(x)))
    return _JAX_NTT[k]


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("k", range(1, 9))
def test_fast_domain_matches_jax(k, radix):
    """Radix 2, radix 4 at even k, and radix 4 at odd k (last level radix 2)."""
    x, want = _jax_ntt(k)
    got = limbs_from_torch(tnf.FastDomain(k, radix=radix, device="cpu").ntt(limbs_to_torch(x, "cpu")))
    np.testing.assert_array_equal(got, want)


def _jax_level(x, tw, s):
    """One radix-2 DIF level on (n, 16) rows from JAX's plain field ops."""
    n = x.shape[0]
    half = n >> (s + 1)
    arr = x.reshape(1 << s, 2, half, 16)
    u, w = arr[:, 0], arr[:, 1]
    t = tw[(np.arange(half) << s) & (n // 2 - 1)]
    sm = jfo.add_mod(JFR, u, w)
    d = jfo.mont_mul(JFR, jfo.sub_mod(JFR, u, w), t)
    return jnp.stack([sm, d], axis=1).reshape(n, 16)


def _tables(tw):
    """(n/2, 16) twiddle rows -> the port's (16, n) per-level tables."""
    return tnf.level_tables(limbs_to_torch(tw.T, "cpu"))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_level_tables_match_jax_stage_gather(k):
    """Level s of the per-level tables, repeated 2^s times, is the plane the
    JAX stage gathers with jnp.take for level s (ops/ntt_fast.py `stage`)."""
    n, nh = 1 << k, 1 << (k - 1)
    tw = _mont(nh, 95)
    jtw = jnp.asarray(tw.T)
    idx = jnp.arange(nh, dtype=jnp.uint32)
    tables = _tables(tw)
    for s in range(k):
        want = np.asarray(jnp.take(jtw, (idx << s) & jnp.uint32(nh - 1), axis=1))
        got = limbs_from_torch(tnf._level(tables, s))
        np.testing.assert_array_equal(np.tile(got, (1, 1 << s)), want)
    assert not limbs_from_torch(tables[:, n - 1:]).any()


@pytest.mark.parametrize("s", range(7))
def test_butterfly4_plain_matches_two_jax_levels(s):
    """Plain K8 at level pair (s, s+1) of n = 256 against two radix-2 levels
    of JAX's plain add_mod, sub_mod and mont_mul."""
    n = 256
    x, tw = _mont(n, 90 + s), _mont(n // 2, 91)
    want = _jax_level(_jax_level(jnp.asarray(x), jnp.asarray(tw), s), jnp.asarray(tw), s + 1)
    got = tnf._butterfly4_plain(limbs_to_torch(x.T, "cpu"), _tables(tw), s)
    np.testing.assert_array_equal(limbs_from_torch(got).T, np.asarray(want))


@pytest.mark.parametrize("s", range(8))
def test_butterfly_plain_matches_jax_level(s):
    n = 256
    x, tw = _mont(n, 100 + s), _mont(n // 2, 101)
    want = _jax_level(jnp.asarray(x), jnp.asarray(tw), s)
    got = tnf.butterfly_t(limbs_to_torch(x.T, "cpu"), _tables(tw), s)
    np.testing.assert_array_equal(limbs_from_torch(got).T, np.asarray(want))


def test_butterfly_level0_matches_jax_kernel():
    """Level 0 of an n = 16 plane is the JAX kernel's (u, w, tw) call on its
    two halves (Pallas interpret mode, m = 8)."""
    m = 8
    u, w, t = _mont(m, 110), _mont(m, 111), _mont(m, 112)
    s_, d = jax_butterfly_t(jnp.asarray(u.T), jnp.asarray(w.T), jnp.asarray(t.T), interpret=True)
    want = np.concatenate([np.asarray(s_), np.asarray(d)], axis=1)
    x = limbs_to_torch(np.concatenate([u, w]).T, "cpu")
    got = tnf.butterfly_t(x, _tables(t), 0)
    np.testing.assert_array_equal(limbs_from_torch(got), want)


def test_bad_level_and_radix_raise():
    x, tw = limbs_to_torch(_mont(16, 120).T, "cpu"), _tables(_mont(8, 121))
    with pytest.raises(ValueError):
        tnf.butterfly_t(x, tw, 4)
    with pytest.raises(ValueError):
        tnf.butterfly4_t(x, tw, 3)
    with pytest.raises(ValueError):
        tnf.butterfly_t(x, tw[:, :8], 0)  # the one (16, n/2) table, not the per-level tables
    with pytest.raises(ValueError):
        tnf.FastDomain(4, radix=8, device="cpu")
    with pytest.raises(ValueError):
        tnf._lg_tile(20, 0, 1, tnf.LG_TILE_MAX + 1)
    with pytest.raises(ValueError):
        tnf._lg_tile(12, 0, 2, 3)  # four runs of 2 elements: no 16-byte accesses


# --- the kernels' block-to-tile mapping (csrc/ntt_fast.cu, mirrored by _tile_plan) ---


def _tiles(k, levels):
    """Every (s, lg_tile) the wrappers take at 2^k: each level, each tile
    size from 2^1 to the largest (a tile is at most the plane)."""
    for s in range(k - levels + 1):
        for lg in range(1, tnf.LG_TILE_MAX + 1):
            try:
                tnf._lg_tile(k, s, levels, lg)
            except ValueError:
                continue
            yield s, lg


@pytest.mark.parametrize("k,levels", [(k, lv) for lv in (1, 2) for k in range(lv, 13)])
def test_tile_plan_partitions_and_holds_butterflies(k, levels):
    """For every level and tile size: the tiles partition [0, n); each
    butterfly's R operands lie in one block's tile, h apart, at its jp;
    every butterfly of the level is taken once; the shared-memory slots are
    a permutation with whole 4-word groups for the 16-byte moves, and a
    warp's 32 butterflies read each operand from 32 different banks."""
    n, R = 1 << k, 1 << levels
    for s, lg in _tiles(k, levels):
        h = n >> (s + levels)
        pos, slot, ops, jp = tnf._tile_plan(k, s, lg, levels)
        E = pos.shape[1]
        assert np.array_equal(np.sort(pos.ravel()), np.arange(n)), (s, lg)
        p0 = pos[:, ops[:, 0]]  # (blocks, E / R): the first operand's position
        for i in range(R):
            assert np.array_equal(pos[:, ops[:, i]], p0 + i * h), (s, lg, i)
        assert np.array_equal(p0 & (R * h - 1), jp) and (jp < h).all(), (s, lg)
        assert len(np.unique(p0)) == n // R
        for b in range(pos.shape[0]):
            assert np.array_equal(np.sort(slot[b]), np.arange(E))
        if E >= 4:
            assert (pos[:, ::4] % 4 == 0).all() and np.array_equal(pos[:, 1::4] - pos[:, ::4], 1 + 0 * pos[:, ::4])
            groups = slot[0].reshape(-1, 4) >> 2
            assert (groups == groups[:, :1]).all(), (s, lg)
        banks = slot[0][ops] % 32  # (E / R, R)
        for w in range(0, len(ops), 32):
            for i in range(R):
                assert len(set(banks[w:w + 32, i])) == len(banks[w:w + 32, i]), (s, lg, w, i)


def _emulate(x, tw, s, lg, levels):
    """The kernel's data flow on the CPU, with the plain field ops: every
    block moves its tile into its slots, runs its radix-2 stages from the
    slots (K7: operands (0, 1) with level s's table at jp; K8: (0, 2) and
    (1, 3) with level s at jp and jp + q, then (0, 1) and (2, 3) with level
    s+1 at jp), writes each output to its input's slot, and moves the tile
    out."""
    k = x.shape[1].bit_length() - 1
    pos, slot, ops, jp = (torch.from_numpy(np.array(a)) for a in tnf._tile_plan(k, s, lg, levels))
    B, E = pos.shape
    smem = torch.empty((B, E, 16), dtype=x.dtype)
    smem.scatter_(1, slot[..., None].expand(B, E, 16), x.T[pos])
    at = slot[:, ops]  # (B, E / R, R) slots of each group's operands
    lvl = tnf._level(tw, s).T
    if levels == 1:
        runs, stages = [lvl[jp]], [[(0, 1, 0)]]
    else:
        q = 1 << (k - s - 2)
        runs = [lvl[jp], lvl[jp + q], tnf._level(tw, s + 1).T[jp]]
        stages = [[(0, 2, 0), (1, 3, 1)], [(0, 1, 2), (2, 3, 2)]]
    for stage in stages:
        for i0, i1, run in stage:
            ia, ib = (at[..., i, None].expand(-1, -1, 16) for i in (i0, i1))
            u0, u1 = smem.gather(1, ia), smem.gather(1, ib)
            smem.scatter_(1, ia, tnf._add(u0, u1))
            smem.scatter_(1, ib, tnf._dmul(u0, u1, runs[run]))
    out = torch.empty_like(x.T)
    out[pos.reshape(-1)] = smem.gather(1, slot[..., None].expand(B, E, 16)).reshape(-1, 16)
    return out.T


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("k", [2, 7, 10])
def test_tile_plan_data_flow_equals_plain(k, levels):
    """The kernel's index arithmetic, run with the plain field ops at every
    level and tile size of 2^k, equals the plain K7/K8 exactly."""
    x = limbs_to_torch(_mont(1 << k, 130 + k).T, "cpu")
    tw = _tables(_mont(1 << (k - 1), 131))
    plain = tnf._butterfly_plain if levels == 1 else tnf._butterfly4_plain
    for s, lg in _tiles(k, levels):
        assert torch.equal(_emulate(x, tw, s, lg, levels), plain(x, tw, s)), (s, lg)
