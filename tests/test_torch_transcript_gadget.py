"""Port parity for the in-circuit Poseidon transcript (gadgets/transcript.py).

The same scripted proof blob goes through the host PoseidonTranscript and
through InCircuitTranscript in both packages, inside one circuit body
written once against each package's API: identical squeezed challenges,
absorbed values and row counts, MockProver passing, and a tampered sponge
state rejected in both."""
import pytest
import torch

from scroll_prover_tpu.gadgets.builder import Builder as JBuilder
from scroll_prover_tpu.gadgets.ecc import EccChip as JEccChip
from scroll_prover_tpu.gadgets.nonnative import NonNativeChip as JNonNativeChip
from scroll_prover_tpu.gadgets.transcript import InCircuitTranscript as JTranscript
from scroll_prover_tpu.proof_system.plonk import Circuit as JCircuit
from scroll_prover_tpu.proof_system.plonk import MockProver as JMockProver
from scroll_prover_tpu.proof_system.plonk.cs import empty_assignment as jempty
from scroll_prover_tpu.zkevm.subcircuits import PoseidonSubCircuit as JPoseidon
from scroll_prover_tpu_torch.curves.bn254_curve import G1, g1_generator
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.gadgets.builder import Builder as TBuilder
from scroll_prover_tpu_torch.gadgets.ecc import EccChip as TEccChip
from scroll_prover_tpu_torch.gadgets.nonnative import NonNativeChip as TNonNativeChip
from scroll_prover_tpu_torch.gadgets.transcript import InCircuitTranscript as TTranscript
from scroll_prover_tpu_torch.proof_system.plonk import Circuit as TCircuit
from scroll_prover_tpu_torch.proof_system.plonk import MockProver as TMockProver
from scroll_prover_tpu_torch.proof_system.plonk.cs import empty_assignment as tempty
from scroll_prover_tpu_torch.proof_system.transcript import PoseidonTranscript
from scroll_prover_tpu_torch.zkevm.subcircuits import PoseidonSubCircuit as TPoseidon

torch.set_num_threads(2)

K = 12
P2 = G1.mul(g1_generator(), 424242)

# a scripted proof blob: two scalars and one point
_W = PoseidonTranscript()
_W.write_scalar(12345)
_W.write_point(P2)
_W.write_scalar(67890)
PROOF = _W.finalize()


def host_stream():
    tr = PoseidonTranscript(PROOF)
    tr.common_scalar(7)  # preamble
    s1 = tr.read_scalar()
    c1 = tr.squeeze_challenge()
    p = tr.read_point()
    c2 = tr.squeeze_challenge()
    s2 = tr.read_scalar()
    c3 = tr.squeeze_challenge()
    return {"s1": s1, "c1": c1, "p": p, "c2": c2, "s2": s2, "c3": c3}


class _TranscriptBody:
    """tests/test_transcript_gadget.py's circuit: the scripted stream read
    in-circuit, one challenge used in builder arithmetic, rows recorded."""

    def __init__(self):
        self.got = {}

    def configure(self, cs):
        self.instance = cs.instance_column()
        cs.enable_permutation(self.instance)
        self.b = self.BUILDER().configure(cs, lookup_bits=11)
        self.pos = self.POSEIDON().configure(cs)
        for col in (self.pos.s[0], self.pos.elem[0], self.pos.elem[1]):
            cs.enable_permutation(col)

    def assign(self, cs, n, instance):
        fixed = self.EMPTY(cs.num_fixed, n)
        adv = self.EMPTY(cs.num_advice, n)
        b = self.b.begin(cs, fixed, adv, n, 0)
        ec = self.ECC(self.NONNATIVE(b))
        tr = self.TRANSCRIPT(b, self.pos, PROOF)
        tr.common_scalar_const(7)
        s1 = tr.read_scalar()
        c1 = tr.squeeze()
        p = tr.read_point(ec)
        c2 = tr.squeeze()
        s2 = tr.read_scalar()
        c3 = tr.squeeze()
        prod = b.mul(c1, s1)  # a challenge cell used across regions
        self.got.update(
            s1=s1.val, c1=c1.val, p=p.value, c2=c2.val, s2=s2.val, c3=c3.val, prod=prod.val,
            transcript_rows=tr.rows_used(), builder_rows=b.rows_used(),
        )
        assert tr.rows_used() < n - 8
        return {"fixed": fixed, "advice": adv}


class JaxTranscriptCircuit(_TranscriptBody, JCircuit):
    BUILDER, POSEIDON, EMPTY, ECC, NONNATIVE, TRANSCRIPT = (
        JBuilder, JPoseidon, staticmethod(jempty), JEccChip, JNonNativeChip, JTranscript)


class TorchTranscriptCircuit(_TranscriptBody, TCircuit):
    BUILDER, POSEIDON, EMPTY, ECC, NONNATIVE, TRANSCRIPT = (
        TBuilder, TPoseidon, staticmethod(tempty), TEccChip, TNonNativeChip, TTranscript)


SIDES = {"jax": (JaxTranscriptCircuit, JMockProver), "torch": (TorchTranscriptCircuit, TMockProver)}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for side, (circ_cls, mock) in SIDES.items():
        circ = circ_cls()
        out[side] = (circ, mock.run(K, circ, [[]]))
    return out


def test_challenges_and_rows_match_host_and_jax(runs):
    want = host_stream()
    t_got = runs["torch"][0].got
    for key, v in want.items():
        assert t_got[key] == v, key
    assert t_got["prod"] == want["c1"] * want["s1"] % FR_MOD
    assert t_got == runs["jax"][0].got


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_mock_prover_passes(runs, side):
    failures = runs[side][1].verify()
    assert failures == [], [str(f) for f in failures[:5]]


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_tampered_state_rejected(side):
    circ_cls, mock = SIDES[side]
    circ = circ_cls()
    mp = mock.run(K, circ, [[]])
    # flip a poseidon state cell mid-permutation
    col = mp.advice[circ.pos.s[0].index]
    for r in range(5, mp.n):
        if col[r] != 0:
            col[r] = (col[r] + 1) % FR_MOD
            break
    assert mp.verify(), "tampered sponge state must fail"
