"""The port's parallel/ over torch.distributed: gloo ranks on the CPU at world
sizes 1, 2 and 4, each rank a spawned process (tests/torch_dist_worker.py,
one spawn per world size running every case), held against the JAX
package: the sharded MSM against its host msm_naive on
tests/test_msm_sharded.py's two cases (whose JAX run is slow-only: its
compile takes minutes), the sharded NTT against its ShardedDomain on the
conftest's 8-device CPU mesh at tests/test_ntt_sharded.py's two shapes.
Exact equality on every rank."""
import jax.numpy as jnp
import numpy as np
import pytest

from scroll_prover_tpu.curves.bn254_curve import G1, g1_generator, msm_naive
from scroll_prover_tpu.fields.bn254 import FR_MOD
from scroll_prover_tpu.fields.limbs import FR_LIMB as JFR
from scroll_prover_tpu.ops import field_ops as jfo
from scroll_prover_tpu.ops.ntt import EvaluationDomain as JaxDomain
from scroll_prover_tpu.parallel.mesh import make_mesh as jax_mesh
from scroll_prover_tpu.parallel.ntt_sharded import ShardedDomain as JaxSharded
from tests.torch_dist_worker import as_arrays, spawn

WORLDS = (1, 2, 4)
# (k, k1, JAX mesh width): tests/test_ntt_sharded.py's default split and its uneven one
NTT_SHAPES = ((9, None, 8), (8, 5, 4))


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(0x5C2011)
    g = g1_generator()
    pts = [G1.mul(g, int(rng.integers(1, 2**61))) for _ in range(64)]
    scalars = [int.from_bytes(rng.bytes(40), "little") % FR_MOD for _ in range(64)]
    zero_heavy = ([G1.mul(g, i + 1) for i in range(32)], [0] * 30 + [7, FR_MOD - 1])
    xs = [np.asarray(jfo.to_mont(JFR, jnp.asarray(jfo.rand_elements(JFR, rng, 1 << k)))) for k, _, _ in NTT_SHAPES]
    return [(pts, scalars), zero_heavy], xs


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    msm, xs = cases
    tmp = str(tmp_path_factory.mktemp("dist"))
    msm_args = [as_arrays(p, s) for p, s in msm]
    ntt_args = [(k, k1, x) for (k, k1, _), x in zip(NTT_SHAPES, xs)]
    return {w: spawn(w, tmp, "sharded_cases", msm_args, ntt_args) for w in WORLDS}


@pytest.fixture(scope="module")
def naive(cases):
    return [msm_naive(pts, scalars) for pts, scalars in cases[0]]


@pytest.fixture(scope="module")
def jax_ntts(cases):
    """(EvaluationDomain.ntt, ShardedDomain.ntt_flat) of the JAX package."""
    out = []
    for (k, k1, width), x in zip(NTT_SHAPES, cases[1]):
        dom = JaxDomain(k)
        out.append((np.asarray(dom.ntt(jnp.asarray(x))),
                    np.asarray(JaxSharded(dom, jax_mesh(width), k1).ntt_flat(jnp.asarray(x)))))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [0, 1], ids=["random64", "zero_heavy32"])
def test_msm_sharded_matches_naive(naive, runs, world, case):
    want = naive[case]
    assert want is not None
    for rank in runs[world]:
        assert rank["msm"][case] == want
        assert rank["msm_tile"][case] == want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [0, 1], ids=["k9", "k8_k1_5"])
def test_sharded_ntt_matches_jax(jax_ntts, runs, world, case):
    single, sharded = jax_ntts[case]
    np.testing.assert_array_equal(sharded, single)
    for rank in runs[world]:
        np.testing.assert_array_equal(rank["ntt"][case], sharded)
