"""Port parity for the slice as a whole at K = 6: keygen, prove and verify of
two circuits, each written against the JAX API and the torch API.

Identical vk bytes, byte-identical proofs for a fixed seed under GWC and
SHPLONK, each side's verifier accepting the other side's proof, a tampered
proof rejected, and the port's proof with every commit routed over a gloo
mesh of 1, 2 and 4 ranks (tests/torch_dist_worker.py) equal to the JAX
package's."""
import pytest
import torch

from scroll_prover_tpu.proof_system import kzg as jkzg
from scroll_prover_tpu.proof_system.plonk import Circuit as JaxCircuit
from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
from scroll_prover_tpu.proof_system.plonk.prover import prove as jprove
from scroll_prover_tpu.proof_system.plonk.verifier import verify as jverify
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.integration.bench_circuit import BenchCircuit
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk import Circuit as TorchCircuit
from scroll_prover_tpu_torch.proof_system.plonk.cs import empty_assignment
from scroll_prover_tpu_torch.proof_system.plonk.keygen import VerifyingKey, keygen as tkeygen
from scroll_prover_tpu_torch.proof_system.plonk.prover import prove as tprove
from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify
from tests.torch_dist_worker import spawn

torch.set_num_threads(2)

K = 6
SEED = b"torch-port-parity"
INSTANCE = [[7]]


class _MulBody:
    """tests/test_plonk.py's MulCircuit: c = a*b on 8 rows, a range-checked
    by a lookup, pi[0] copied to a[0], a self-copy on c[0]."""

    def configure(self, cs):
        self.a = cs.advice_column()
        self.b = cs.advice_column()
        self.c = cs.advice_column()
        self.sel = cs.selector()
        self.tbl = cs.fixed_column()
        self.pi = cs.instance_column()
        cs.gate("mul", self.sel.query() * (self.a.query() * self.b.query() - self.c.query()))
        cs.lookup("a_range", [self.sel.query() * self.a.query()], [self.tbl.query()])

    def assign(self, cs, n, instance):
        fixed = empty_assignment(cs.num_fixed, n)
        advice = empty_assignment(cs.num_advice, n)
        pi0 = int(instance[self.pi.index][0])
        for i in range(8):
            a, b = pi0 + i, i + 5
            advice[self.a.index][i] = a
            advice[self.b.index][i] = b
            advice[self.c.index][i] = a * b % FR_MOD
            fixed[self.sel.index][i] = 1
        for i, v in enumerate(range(41)):
            fixed[self.tbl.index][i] = v
        cs.copy(self.pi, 0, self.a, 0)
        cs.copy(self.c, 0, self.c, 0)
        return {"fixed": fixed, "advice": advice}


class JaxMul(_MulBody, JaxCircuit):
    pass


class TorchMul(_MulBody, TorchCircuit):
    pass


class JaxBench(JaxCircuit):
    """The port's BenchCircuit body against the JAX API."""

    __init__ = BenchCircuit.__init__
    configure = BenchCircuit.configure
    assign = BenchCircuit.assign


CIRCUITS = {
    "mul": (JaxMul, TorchMul),
    "bench": (lambda: JaxBench(8), lambda: BenchCircuit(8)),
}


@pytest.fixture(scope="module")
def srs_pair():
    return jkzg.SRS.generate(K), tkzg.SRS.generate(K, device="cpu")


@pytest.fixture(scope="module")
def keys(srs_pair):
    js, ts = srs_pair
    out = {}
    for name, (jc, tc) in CIRCUITS.items():
        jcirc, tcirc = jc(), tc()
        out[name] = (jcirc, tcirc, jkeygen(js, K, jcirc), tkeygen(ts, K, tcirc))
    return out


@pytest.fixture(scope="module")
def proofs(srs_pair, keys):
    js, ts = srs_pair
    out = {}
    for name, (jcirc, tcirc, (jpk, _), (tpk, _)) in keys.items():
        for mo in ("gwc", "shplonk"):
            out[name, mo] = (
                jprove(js, jpk, jcirc, INSTANCE, seed=SEED, multiopen=mo),
                tprove(ts, tpk, tcirc, INSTANCE, seed=SEED, multiopen=mo),
            )
    return out


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_vk_bytes_identical(keys, name):
    _, _, (_, jvk), (_, tvk) = keys[name]
    assert tvk.to_bytes() == jvk.to_bytes()
    back = VerifyingKey.from_bytes(jvk.to_bytes())
    assert back.to_bytes() == jvk.to_bytes()


@pytest.mark.parametrize("mo", ["gwc", "shplonk"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_proof_bytes_identical(proofs, name, mo):
    jp, tp = proofs[name, mo]
    assert tp == jp


@pytest.mark.parametrize("mo", ["gwc", "shplonk"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_cross_verify(srs_pair, keys, proofs, name, mo):
    js, ts = srs_pair
    _, _, (_, jvk), (_, tvk) = keys[name]
    jp, tp = proofs[name, mo]
    assert tverify(ts, tvk, INSTANCE, jp, multiopen=mo)
    assert jverify(js, jvk, INSTANCE, tp, multiopen=mo)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_tampered_and_wrong_instance_rejected(srs_pair, keys, proofs, name):
    _, ts = srs_pair
    _, _, _, (_, tvk) = keys[name]
    _, tp = proofs[name, "gwc"]
    bad = bytearray(tp)
    bad[70] ^= 1
    assert not tverify(ts, tvk, INSTANCE, bytes(bad))
    assert not tverify(ts, tvk, [[8]], tp)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_routed_proof_bytes_identical(proofs, world, tmp_path):
    """BenchCircuit proved by `world` gloo ranks with every commit routed over
    their mesh (SPT_DEVICE_MSM_THRESHOLD lowered to 2^K, as
    __graft_entry__.dryrun_multichip lowers it): each rank's bytes equal the
    JAX package's unrouted proof."""
    jp, _ = proofs["bench", "gwc"]
    for rank in spawn(world, str(tmp_path), "routed_proof", K, 8, INSTANCE, SEED, "gwc"):
        assert rank["host"] == 0 and rank["routed"] > 0, rank
        assert rank["proof"] == jp
