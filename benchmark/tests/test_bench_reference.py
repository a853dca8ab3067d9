"""The plain reference (benchref/) against the port on the CPU: each check
passes on the port's outputs and fails on an output with one bit changed."""
import random

import pytest
from benchref import checks, curve, field
from benchref.keccak import keccak256

K = 6
N = 1 << K


def _col(vals):
    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB, limbs_to_torch

    return limbs_to_torch(FR_LIMB.encode(vals), "cpu")


def test_keccak_vectors():
    assert keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"


def test_keccak_agrees_with_the_port():
    from scroll_prover_tpu_torch.hashes.keccak import keccak256 as port

    rng = random.Random(3)
    for n in (1, 135, 136, 137, 400):
        data = rng.randbytes(n)
        assert keccak256(data) == port(data)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("scale", [None, "geometric", "random"])
def test_ntt_check(inverse, scale):
    from scroll_prover_tpu_torch.ops.ntt_tile import TiledDomain

    rng = random.Random(11)
    x = _col([rng.randrange(field.R) for _ in range(N)])
    tables = {None: None, "geometric": [pow(5, j, field.R) for j in range(N)],
              "random": [rng.randrange(1, field.R) for _ in range(N)]}
    sc = None if scale is None else _col(tables[scale])
    y = TiledDomain(K, "cpu")._transform(x[None], inverse, sc)[0]
    z = rng.randrange(field.R)
    sample = {"n": N, "inverse": inverse, "position": rng.randrange(N), "inp": x.numpy(), "out": y.numpy(),
              "scale": None if sc is None else sc.numpy()}
    bad = y.clone()
    bad[rng.randrange(N), 0] ^= 1
    # 0 of the good sample, 1 of the bad one; serially and over ranges of 16 rows
    for parts in (1, 4):
        assert checks.judge([sample, dict(sample, out=bad.numpy())], [], 1, z, parts=parts) == (1, 0)
    assert checks.judge([sample], [], 1, z) == (0, 0)


@pytest.mark.parametrize("basis", ["monomial", "lagrange"])
def test_msm_check(basis):
    from scroll_prover_tpu_torch.fields.limbs import ints_to_limbs, limbs_to_torch
    from scroll_prover_tpu_torch.ops import msm_tile
    from scroll_prover_tpu_torch.proof_system.kzg import SRS

    seed = b"benchmark-reference-test"
    srs = SRS.generate_fast(K, seed=seed, device="cpu")
    tau = checks.tau_of(seed)
    rng = random.Random(5)
    sc = limbs_to_torch(ints_to_limbs([rng.randrange(field.R) for _ in range(N)]), "cpu")
    base = srs.dev_powers() if basis == "monomial" else srs.dev_lagrange()
    for n in (N, N // 4):  # a whole basis and a prefix of it
        pt = msm_tile.msm_v2_host_batch(base[:n], [sc[:n]])[0]
        sample = {"scalars": sc[:n].numpy(), "basis": basis, "basis_n": N, "point": pt}
        assert checks.judge([], [sample], tau, tau) == (0, 0)
        bad = dict(sample, point=(pt[0], field.Q - pt[1]))
        assert checks.judge([], [sample, bad, dict(sample, basis="unknown")], tau, tau, parts=4) == (0, 2)


def test_sums_in_a_pool_equal_the_serial_ones():
    import multiprocessing

    from benchref.linear import Sums

    rng = random.Random(8)
    cols = [_col([rng.randrange(field.R) for _ in range(1 << 13)]).numpy() for _ in range(2)]
    geo = _col([pow(7, j, field.R) * 3 % field.R for j in range(1 << 13)]).numpy()
    x = rng.randrange(field.R)

    def plan(parts):
        s = Sums(parts)
        return s, [s.powers(x, cols[0]), s.powers(x, cols[0], cols[1], "div"), s.lagrange(x, 1 << 13, cols[1]),
                   s.lagrange(x, 1 << 14, cols[0][:5000]), s.geometric(geo), s.geometric(cols[0])]

    serial, slots = plan(1)
    want = [serial.run()[i] for i in slots]
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        par, slots = plan(4)
        got = [par.run(pool)[i] for i in slots]
        pool.close()
        pool.join()
    assert got == want and want[-2] is True and want[-1] is False
    assert field.horner(field.limbs_to_ints(cols[0]), x) == want[0]


@pytest.mark.parametrize("lengths", [[N], [N, N // 4, 1, 3 * N]])
def test_eval_many_equals_horner(lengths):
    """The matrix product's evaluation equals Horner's on Montgomery limbs,
    for columns of several lengths at several points."""
    from benchref.opening import eval_many

    rng = random.Random(4)
    cols = [[rng.randrange(field.R) for _ in range(m)] for m in lengths]
    cols[0][0] = field.R - 1  # a large top limb
    arrays = [_col(c).numpy() for c in cols]
    points = [rng.randrange(field.R), 1, field.R - 1]
    got = eval_many(arrays, points)
    assert got == [[field.horner(c, z) for z in points] for c in cols]
    arrays[0][5, 3] ^= 1
    assert eval_many(arrays[:1], points)[0] != got[0]


def test_curve_mul_matches_the_port():
    from scroll_prover_tpu_torch.curves.bn254_curve import G1, g1_generator

    for k in (1, 2, 3, 2**200 + 12345, field.R - 1):
        assert curve.mul(curve.G1, k) == G1.mul(g1_generator(), k)
    assert curve.mul(curve.G1, field.R) is None
