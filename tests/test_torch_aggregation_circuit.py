"""Port parity for the AggregationCircuit (prover/aggregation_circuit.py) and
the in-circuit blob evaluation (gadgets/blob_eval.py): the twin of
tests/test_aggregation_circuit.py's fast cases.

The inner proofs are tests/test_torch_plonk.py's MulCircuit at K = 6 (GWC),
proved twice by the port; the JAX package reads the port's vk bytes. One
counting run of the port's circuit over both inners, with a link, two
exposed cells and the blob at width 64, is shared by the cases: its fold,
digest, blob digest and exposed cells equal the port's and the JAX
package's host instance (`instance_for()`, no gadget run there), and the
fold's pairing holds. A wrong y is refused by the blob gadget of both
packages, a violated link by the port's circuit, a tampered member by the
host accumulator of both. Exact equality throughout: these are integers.
tests/test_torch_aggregation_shape.py holds rows, min_k and the circuit's
shape against a JAX counting run."""
import pytest
import torch

import tests.torch_native_cases  # noqa: F401  (both packages' native libraries, built once under a lock)
from scroll_prover_tpu.gadgets.blob_eval import BlobEvalGadget as JBlobEvalGadget
from scroll_prover_tpu.gadgets.builder import Builder as JBuilder
from scroll_prover_tpu.proof_system.plonk.cs import ConstraintSystem as JConstraintSystem
from scroll_prover_tpu.proof_system.plonk.keygen import VerifyingKey as JVerifyingKey
from scroll_prover_tpu.prover.aggregation_circuit import AggregationCircuit as JAggregationCircuit
from scroll_prover_tpu_torch.aggregator.blob import BLS_MODULUS, blob_to_coefficients
from scroll_prover_tpu_torch.gadgets.blob_eval import BlobEvalGadget, _brp_domain
from scroll_prover_tpu_torch.gadgets.builder import Builder
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk.cs import ConstraintSystem
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from scroll_prover_tpu_torch.proof_system.plonk.prover import prove as tprove
from scroll_prover_tpu_torch.proof_system.plonk.verifier import acc_from_limbs, check_accumulator
from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify
from scroll_prover_tpu_torch.prover.aggregation_circuit import AggregationCircuit
from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS, LOOKUP_BITS, _SinkCols
from tests.test_torch_plonk import INSTANCE, K, TorchMul

torch.set_num_threads(2)

WIDTH = 64
BLOB = bytes(range(256)) * 9  # enough bytes for 64 coefficients of 31 bytes
M128 = (1 << 128) - 1


def blob_context(blob: bytes = BLOB, width: int = WIDTH, y_shift: int = 0) -> list[int]:
    """[7, 8, z hi/lo, y hi/lo] with y the blob's evaluation at a fixed z
    over the width-limited brp domain (plus y_shift)."""
    p = BLS_MODULUS
    coeffs = blob_to_coefficients(blob)[:width]
    z = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF123456789 % p
    total = sum(c * w % p * pow((z - w) % p, -1, p) % p for c, w in zip(coeffs, _brp_domain(width))) % p
    y = ((pow(z, width, p) - 1) * pow(width, -1, p) % p * total + y_shift) % p
    return [7, 8, z >> 128, z & M128, y >> 128, y & M128]


def limbs(lhs, rhs) -> list[int]:
    out = []
    for pt in (lhs, rhs):
        for coord in pt:
            out += [(coord >> (88 * i)) & ((1 << 88) - 1) for i in range(3)]
    return out


@pytest.fixture(scope="module")
def srs():
    return tkzg.SRS.generate(K, device="cpu")


@pytest.fixture(scope="module")
def inners(srs):
    """(port inners, JAX inners): two MulCircuit proofs under one vk, the
    JAX vk read from the port's vk bytes."""
    circ = TorchMul()
    pk, tvk = tkeygen(srs, K, circ)
    jvk = JVerifyingKey.from_bytes(tvk.to_bytes())
    t, j = [], []
    for seed in (b"agg-a", b"agg-b"):
        proof = tprove(srs, pk, circ, INSTANCE, seed=seed)
        assert tverify(srs, tvk, INSTANCE, proof)
        t.append((tvk, proof, INSTANCE[0]))
        j.append((jvk, proof, INSTANCE[0]))
    return t, j


AGG = dict(context=blob_context(), inners_have_acc=False, links=[(0, 0, 1, 0)], expose=[(0, 0), (1, 0)],
           blob_bytes=BLOB, blob_width=WIDTH)


@pytest.fixture(scope="module")
def counted(inners):
    """One counting run of the port's circuit over both inners."""
    circ = AggregationCircuit(inners[0], **AGG)
    cs = ConstraintSystem()
    circ.configure(cs)
    b, lhs, rhs, digest, ctx_cells, exp_cells = circ._run(cs, _SinkCols(), _SinkCols(), 1 << 30)
    (ca, ra), (cb, rb) = ((c.col, c.row) for c in exp_cells)
    return {
        "acc": limbs(lhs.value, rhs.value), "digest": digest.val, "ctx": [c.val for c in ctx_cells],
        "exp": [c.val for c in exp_cells], "exp_distinct": (ca, ra) != (cb, rb),
        "link_copied": ((ca, ra), (cb, rb)) in set(cs.copies), "rows": b.rows_used(),
    }


def test_counting_matches_instance_for(srs, inners, counted):
    """The in-circuit fold, digest, context, blob digest and exposed cells
    equal the port's host instance, which equals the JAX package's; the
    folded accumulator's pairing covers both inner proofs."""
    want = AggregationCircuit(inners[0], **AGG).instance_for()[0]
    assert want == JAggregationCircuit(inners[1], **AGG).instance_for()[0]
    assert counted["acc"] == want[:ACC_CELLS]
    assert counted["digest"] == want[ACC_CELLS]
    ctx = AGG["context"]
    # the context cells, then the blob digest cell
    assert counted["ctx"] == want[ACC_CELLS + 1: ACC_CELLS + 2 + len(ctx)]
    assert want[ACC_CELLS + 1: ACC_CELLS + 1 + len(ctx)] == ctx
    assert want[ACC_CELLS + 1 + len(ctx)] == AggregationCircuit.host_blob_digest(BLOB, WIDTH) \
        == JAggregationCircuit.host_blob_digest(BLOB, WIDTH)
    assert check_accumulator(srs, *acc_from_limbs(want[:ACC_CELLS]))


def test_exposed_cells_carry_inner_values(inners, counted):
    want = AggregationCircuit(inners[0], **AGG).instance_for()[0]
    assert counted["exp"] == [INSTANCE[0][0], INSTANCE[0][0]] == want[-2:]
    assert AggregationCircuit(inners[0], **AGG).num_instance() == ACC_CELLS + 1 + 6 + 1 + 2


def test_link_adds_its_copy(counted):
    """The link (inner 0's cell 0 == inner 1's cell 0) is a copy constraint
    between the two cells the circuit also exposes."""
    assert counted["exp_distinct"]
    assert counted["link_copied"]


def test_tampered_blob_changes_digest():
    bad = bytearray(BLOB)
    bad[3] ^= 1
    want = AggregationCircuit.host_blob_digest(BLOB, WIDTH)
    assert AggregationCircuit.host_blob_digest(bytes(bad), WIDTH) != want
    assert JAggregationCircuit.host_blob_digest(bytes(bad), WIDTH) == \
        AggregationCircuit.host_blob_digest(bytes(bad), WIDTH)


class _NoVerify:
    """Stands in for the in-circuit verifier in the violated-link case: the
    link is checked after every inner's gadget, whose cells it does not
    read (the shared counting run holds the gadgets)."""

    def __init__(self, b, *_a, **_k):
        pass

    def run(self, transcript_row0=0):
        self.transcript_rows = transcript_row0
        return None, None


def test_violated_link_refused(inners, monkeypatch):
    """An inner whose declared instance breaks the link: honest witness
    generation fails at the link's equality."""
    from scroll_prover_tpu_torch.prover import aggregation_circuit as agg_mod

    monkeypatch.setattr(agg_mod, "VerifierGadget", _NoVerify)
    (vk, _p0, _i0), (_vk, p1, _i1) = inners[0]
    circ = AggregationCircuit([inners[0][0], (vk, p1, [99])], context=[], inners_have_acc=False,
                              links=[(0, 0, 1, 0)])
    cs = ConstraintSystem()
    circ.configure(cs)
    with pytest.raises(AssertionError, match="assert_equal"):
        circ._run(cs, _SinkCols(), _SinkCols(), 1 << 30)


def _outcome(circ, srs):
    try:
        lm = circ.instance_for()[0][:ACC_CELLS]
    except (AssertionError, ValueError):
        return "raised"
    return check_accumulator(srs, *acc_from_limbs(lm)), lm


def test_tampered_member_rejected(srs, inners):
    """A tampered member proof: the host accumulator raises or fails its
    pairing, the same in both packages."""
    outs = []
    for agg_cls, inn in ((AggregationCircuit, inners[0]), (JAggregationCircuit, inners[1])):
        (vk, proof, inst), other = inn
        bad = bytearray(proof)
        bad[9] ^= 1
        outs.append(_outcome(agg_cls([(vk, bytes(bad), inst), other], context=[], inners_have_acc=False), srs))
    assert outs[0] == outs[1]
    assert outs[0] == "raised" or outs[0][0] is False


def _blob_gadget(builder_cls, cs_cls, gadget_cls, ctx):
    """The blob gadget alone at WIDTH on a fresh builder (counting mode):
    its rows and the (hi, lo) coefficient values it witnessed."""
    cs = cs_cls()
    b = builder_cls().configure(cs, lookup_bits=LOOKUP_BITS).begin(cs, _SinkCols(), _SinkCols(), 1 << 30, 0)
    z_hi, z_lo, y_hi, y_lo = (b.witness(v) for v in ctx[2:6])
    pairs = gadget_cls(b, width=WIDTH).run(blob_to_coefficients(BLOB)[:WIDTH], z_hi, z_lo, y_hi, y_lo)
    return b.rows_used(), [(hi.val, lo.val) for hi, lo in pairs]


def test_blob_gadget_matches_jax():
    """At the right y both blob gadgets build, with equal rows and cells."""
    got = _blob_gadget(Builder, ConstraintSystem, BlobEvalGadget, blob_context())
    assert got == _blob_gadget(JBuilder, JConstraintSystem, JBlobEvalGadget, blob_context())
    assert got[0] > 200 * WIDTH


def test_blob_gadget_rejects_wrong_y():
    for builder_cls, cs_cls, gadget_cls in ((Builder, ConstraintSystem, BlobEvalGadget),
                                            (JBuilder, JConstraintSystem, JBlobEvalGadget)):
        with pytest.raises(AssertionError):
            _blob_gadget(builder_cls, cs_cls, gadget_cls, blob_context(y_shift=1))
