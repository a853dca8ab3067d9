"""Port parity: the torch field core (plain K1 on the CPU) against the JAX
package's field_ops, exact equality (integer arithmetic: tolerance 0)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.fields.limbs import FQ_LIMB as JFQ, FR_LIMB as JFR
from scroll_prover_tpu.ops import field_ops as jfo
from scroll_prover_tpu_torch.fields.limbs import (
    FQ_LIMB, FR_LIMB, limbs_from_torch, limbs_to_torch, limbs_to_words, words_to_limbs,
)
from scroll_prover_tpu_torch.ops import field_ops as tfo

torch.set_num_threads(2)

FIELDS = {"fr": (JFR, FR_LIMB), "fq": (JFQ, FQ_LIMB)}
N = 129


def _operands(tf, seed):
    rng = np.random.default_rng(seed)
    a = tfo.rand_elements(tf, rng, N)
    b = tfo.rand_elements(tf, rng, N)
    a[0] = 0
    b[1] = 0
    a[2] = tf.encode([tf.modulus - 1], mont=False)[0]  # p - 1
    b[2] = a[2]
    b[3] = tf.encode([1], mont=False)[0]
    return a, b


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", ["add_mod", "sub_mod", "mont_mul"])
def test_binary_ops_match_jax(field, op):
    jf, tf = FIELDS[field]
    a, b = _operands(tf, 11)
    want = np.asarray(getattr(jfo, op)(jf, jnp.asarray(a), jnp.asarray(b)))
    got = limbs_from_torch(getattr(tfo, op)(tf, limbs_to_torch(a, "cpu"), limbs_to_torch(b, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", ["neg_mod", "batch_inv_mont", "to_mont", "from_mont", "pow_13"])
def test_unary_ops_match_jax(field, op):
    jf, tf = FIELDS[field]
    a, _ = _operands(tf, 12)
    ja, ta = jnp.asarray(a), limbs_to_torch(a, "cpu")
    if op == "pow_13":
        want, got = jfo.pow_mont(jf, ja, 13), tfo.pow_mont(tf, ta, 13)
    else:
        want, got = getattr(jfo, op)(jf, ja), getattr(tfo, op)(tf, ta)
    np.testing.assert_array_equal(limbs_from_torch(got), np.asarray(want))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_mont_matches_jax(field):
    jf, tf = FIELDS[field]
    a, _ = _operands(tf, 13)
    a = a[:4]
    want = np.asarray(jfo.inv_mont(jf, jnp.asarray(a)))
    got = limbs_from_torch(tfo.inv_mont(tf, limbs_to_torch(a, "cpu")))
    np.testing.assert_array_equal(got, want)


def _carry_heavy(tf, n, seed):
    """Canonical values whose limbs are mostly 0xFFFF, 0x0000 and their
    neighbours, where carries and borrows run through many limbs."""
    rng = np.random.default_rng(seed)
    words = ["ffff", "0000", "fffe", "0001"]
    vals = [0, 1, tf.modulus - 1, tf.modulus - 2, (1 << 255) % tf.modulus]
    vals += [int("".join(rng.choice(words) for _ in range(16)), 16) % tf.modulus for _ in range(n)]
    return tf.encode(vals, mont=False)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_plain_products_agree_on_carry_heavy_limbs(field, monkeypatch):
    """The plain product (`_redc_rows`, and `_mont_mul_plain` over steps of
    a few rows), the plain add and sub, and the carry's in-order pass that
    runs on the card against its rounds, against host integers on every
    pair of carry-heavy values."""
    monkeypatch.setattr(tfo, "_MUL_ROWS", 300)
    _, tf = FIELDS[field]
    p = tf.modulus
    vals = _carry_heavy(tf, 40, 7)
    a = np.repeat(vals, len(vals), axis=0)
    b = np.tile(vals, (len(vals), 1))
    ta, tb = limbs_to_torch(a, "cpu"), limbs_to_torch(b, "cpu")
    ai, bi = tf.decode(a, mont=False), tf.decode(b, mont=False)
    rinv = pow(1 << 256, -1, p)
    want = tf.encode([x * y * rinv % p for x, y in zip(ai, bi)], mont=False)
    np.testing.assert_array_equal(limbs_from_torch(tfo._redc_rows(tf, ta.long(), tb.long())), want)
    np.testing.assert_array_equal(limbs_from_torch(tfo._mont_mul_plain(tf, ta, tb)), want)
    for s in (ta.long() + tb.long(), ta.long() - tb.long(), ta.long()[:, :, None] * tb.long()[:, None, :]):
        s = s.reshape(s.shape[0], -1)
        for got, ref in zip(tfo._carry_in_order(s), tfo._carry(s)):
            assert torch.equal(got, ref)
    np.testing.assert_array_equal(limbs_from_torch(tfo._add_mod_plain(tf, ta, tb)),
                                  tf.encode([(x + y) % p for x, y in zip(ai, bi)], mont=False))
    np.testing.assert_array_equal(limbs_from_torch(tfo._sub_mod_plain(tf, ta, tb)),
                                  tf.encode([(x - y) % p for x, y in zip(ai, bi)], mont=False))


def test_broadcast_scalar_product():
    """A (16,) scalar broadcast over a column, as the prover's constants are."""
    a, b = _operands(FR_LIMB, 14)
    want = np.asarray(jfo.mont_mul(JFR, jnp.asarray(a), jnp.asarray(b[5])[None, :]))
    got = tfo.mont_mul(FR_LIMB, limbs_to_torch(a, "cpu"), limbs_to_torch(b[5], "cpu"))
    np.testing.assert_array_equal(limbs_from_torch(got), want)


def test_word_packing_roundtrip():
    """limbs <-> 32-bit words (the kernels' bucket format), incl. words >= 2^31."""
    a, _ = _operands(FQ_LIMB, 15)
    t = limbs_to_torch(a, "cpu")
    w = limbs_to_words(t)
    assert torch.equal(words_to_limbs(w), t)
    want = (a[:, 0::2].astype(np.uint64) | (a[:, 1::2].astype(np.uint64) << 16)).astype(np.uint32)
    np.testing.assert_array_equal(w.numpy().view(np.uint32), want)


def test_kernel_wrapper_rejects_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it never computes
    on the CPU itself."""
    a = limbs_to_torch(_operands(FR_LIMB, 16)[0], "cpu")
    with pytest.raises(ValueError):
        tfo.mont_mul_k1(FR_LIMB, a, a)


@pytest.mark.parametrize("mode", ["mul_add", "mul_sub", "add", "sub", "neg"])
def test_k1_mode_wrappers_reject_cpu_tensors(mode):
    """Every K1 mode's wrapper launches on CUDA tensors or raises."""
    a = limbs_to_torch(_operands(FR_LIMB, 18)[0], "cpu")
    calls = {
        "mul_add": lambda: tfo.mont_mul_k1(FR_LIMB, a, a, c=a),
        "mul_sub": lambda: tfo.mont_mul_k1(FR_LIMB, a, a, c=a, sub=True),
        "add": lambda: tfo.add_sub_k1(FR_LIMB, tfo.ADD, a, a),
        "sub": lambda: tfo.add_sub_k1(FR_LIMB, tfo.SUB, a, a),
        "neg": lambda: tfo.add_sub_k1(FR_LIMB, tfo.NEG, a),
    }
    with pytest.raises(ValueError):
        calls[mode]()


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("sub", [False, True], ids=["mul_add", "mul_sub"])
def test_mont_mul_add_matches_jax(field, sub):
    """K1's fused modes (plain versions here): a*b + c and a*b - c against
    JAX's add_mod(mont_mul(a, b), c) and sub_mod(mont_mul(a, b), c), with c
    a column and a broadcast scalar."""
    jf, tf = FIELDS[field]
    a, b = _operands(tf, 19)
    c, _ = _operands(tf, 20)
    ja, jb, jc = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    jop = jfo.sub_mod if sub else jfo.add_mod
    ta, tb, tc = (limbs_to_torch(x, "cpu") for x in (a, b, c))
    for c_t, c_j in ((tc, jc), (tc[7], jc[7][None, :])):
        want = np.asarray(jop(jf, jfo.mont_mul(jf, ja, jb), c_j))
        got = limbs_from_torch(tfo.mont_mul_add(tf, ta, tb, c_t, sub=sub))
        np.testing.assert_array_equal(got, want)


def test_k1_operand_strides():
    """The (element stride, limb stride) K1 is given for each operand
    layout the main path passes, and a copy only where no one stride fits."""
    x = torch.zeros((6, 5, 16), dtype=torch.int32)
    assert tfo._operand(x)[1:] == (16, 1)  # row-major
    plane = torch.zeros((16, 30), dtype=torch.int32)
    assert tfo._operand(plane.T)[1:] == (1, 30)  # a limb-major plane seen as (N, 16)
    y = plane.reshape(16, 6, 5).permute(1, 2, 0)  # (6, 5, 16) view of a limb-major plane
    t, es, ls = tfo._operand(y)
    assert t is y and (es, ls) == (1, 30)
    s = torch.zeros(16, dtype=torch.int32).expand(6, 5, 16)  # broadcast scalar
    assert tfo._operand(s)[1:] == (0, 1)
    odd = x[:, ::2]  # two element strides: copied
    t, es, ls = tfo._operand(odd)
    assert t.is_contiguous() and (es, ls) == (16, 1)


def test_poseidon_dev_matches_jax():
    """Batched Poseidon hash2 over 16 rows (zero, r - 1 and a domain tag)
    against the JAX package's PoseidonDev, and the host sponge."""
    from scroll_prover_tpu.ops.poseidon_dev import PoseidonDev as JaxPoseidonDev
    from scroll_prover_tpu_torch.hashes.poseidon import poseidon_fr
    from scroll_prover_tpu_torch.ops.poseidon_dev import PoseidonDev

    rng = np.random.default_rng(17)
    a = [int.from_bytes(rng.bytes(32), "little") % FR_LIMB.modulus for _ in range(16)]
    b = [int.from_bytes(rng.bytes(32), "little") % FR_LIMB.modulus for _ in range(16)]
    a[0], b[0], b[1] = 0, 0, FR_LIMB.modulus - 1
    got = PoseidonDev(device="cpu").hash2_batch(a, b, domain=3)
    assert got == JaxPoseidonDev().hash2_batch(a, b, domain=3)
    assert got == [poseidon_fr.hash2(x, y, domain=3) for x, y in zip(a, b)]


@pytest.mark.parametrize("shape", ["small", "negative", "big", "mixed"])
def test_objcol_to_packed_and_device_codec(shape):
    """Assignment columns -> packed canonical words, equal to the JAX
    package's objcol_to_packed on every value shape (the port also sends
    mixed columns' small values through the vectorized path); the packed
    words cross to limbs and back (limbs_to_words) on the tensor's device
    unchanged."""
    from scroll_prover_tpu.fields.limbs import objcol_to_packed as jpack
    from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
    from scroll_prover_tpu_torch.fields.limbs import (
        ints_to_limbs, objcol_to_packed, packed_to_torch,
    )

    rng = np.random.default_rng(7)
    small = [int(v) for v in rng.integers(0, 1 << 62, 40)] + [0, 1, (1 << 62) - 1, (1 << 63) - 1]
    big = [int.from_bytes(rng.bytes(32), "little") for _ in range(40)] + [FR_MOD, FR_MOD - 1, FR_MOD + 5]
    cols = {
        "small": small,
        "negative": [-1, -(1 << 70), 5, 0, -FR_MOD - 3],
        "big": big,
        "mixed": small + big + [-7, 1 << 62, (1 << 62) + 1, 2**64] + small,
    }
    col = np.empty(len(cols[shape]), dtype=object)
    col[:] = cols[shape]
    got = objcol_to_packed(col)
    assert got.dtype == np.uint32 and got.shape == (len(col), 8)
    assert np.array_equal(got, jpack(col))
    want_limbs = ints_to_limbs([int(v) % FR_MOD for v in col])
    assert np.array_equal(limbs_from_torch(packed_to_torch(got, "cpu")), want_limbs)
    words = limbs_to_words(limbs_to_torch(want_limbs, "cpu"))
    assert np.array_equal(words.numpy().view(np.uint32), got)
