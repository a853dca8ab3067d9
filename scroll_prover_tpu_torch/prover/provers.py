"""ChunkProver / ChunkVerifier / BatchProver / BatchVerifier + params io.

API parity with the reference prover crate (SURVEY.md section 2.3):
`ChunkProver::from_params_and_assets` + `gen_halo2_chunk_proof(task, id,
inner_id, output_dir)` (integration/src/prove.rs:30,38), the verifier
counterparts (prove.rs:50-53, 75-80), `Prover::load_params_map(dir,
degrees)` (bin/src/trace_prover.rs:35-36), CHUNK/BATCH_PROVER_DEGREES.

Chunk pipeline (reference stack 3.1): witness -> ScrollSuperCircuit inner
proof -> layer1 compression -> layer2 compression (thin) = chunk proof.
Domains auto-shrink to the witness in test mode; production degrees follow
the reference ladder (inner 20; layers 24/25 — integration/configs).

The prover and verifier run on `device` (the card unless the caller passes
device="cpu"); an SRS the params map lacks is generated there.
"""
from __future__ import annotations

import logging
import os

from ..device import resolve_device
from ..fields.bn254 import FR_MOD
from ..proof_system import kzg
from ..proof_system.plonk.keygen import keygen
from ..proof_system.plonk.prover import prove as plonk_prove
from ..proof_system.plonk.verifier import acc_from_limbs, check_accumulator
from ..proof_system.plonk.verifier import verify as plonk_verify
from ..witness.block import chunk_trace_to_witness_block
from ..witness.capacity import calculate_row_usage_of_witness_block
from ..zkevm import INNER_DEGREE, ScrollSuperCircuit, chunk_instance
from .chunk_info import ChunkInfo
from .proofs import ChunkProofInner, ChunkProofV2, ProofPayload
from .protocol import protocol_from_vk
from .tasks import ChunkProvingTask
from .verifier_circuit import ACC_CELLS, VerifierCircuit

log = logging.getLogger(__name__)

# production ladder degrees (reference integration/configs/layer*.config)
LAYER_DEGREES = {1: 24, 2: 25, 3: 21, 4: 26, 5: 21, 6: 26}


def _ladder_multiopen() -> str:
    """Multiopen scheme for the inner proof and layers 1-5 (reference
    parity: the scroll halo2 fork proves the compression/aggregation
    layers with SHPLONK/BDFG21 and keeps GWC for the EVM-facing layer6,
    whose fold the generated bytecode re-derives — Cargo.lock
    halo2_proofs features). SPT_LADDER_MULTIOPEN reverts the whole ladder
    to GWC."""
    mo = os.environ.get("SPT_LADDER_MULTIOPEN", "shplonk")
    assert mo in ("gwc", "shplonk"), mo
    return mo


def _mo_tag(shape_id: str, mo: str) -> str:
    return shape_id if mo == "gwc" else f"{shape_id}_{mo}"


CHUNK_PROVER_DEGREES = [INNER_DEGREE, LAYER_DEGREES[1], LAYER_DEGREES[2]]
BATCH_PROVER_DEGREES = [LAYER_DEGREES[3], LAYER_DEGREES[4], LAYER_DEGREES[5], LAYER_DEGREES[6]]


def _generate_srs(k: int, device) -> kzg.SRS:
    """The toy SRS of degree k on `device`: `SRS.generate_fast` on the card
    (tau powers, Lagrange scalars and the fixed-base multiples there, K5),
    `SRS.generate` on the CPU. Both give the same points bit for bit; the
    host loop of `generate` would take hours at the ladder's degrees."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return kzg.SRS.generate_fast(k, device=dev)
    return kzg.SRS.generate(k, device=dev)


def load_params(params_dir: str, degree: int, device=None) -> kzg.SRS:
    """Load `params{degree}` from dir; generate+cache a toy SRS if absent
    (the reference downloads ceremony files — download_setup.sh)."""
    path = os.path.join(params_dir, f"params{degree}")
    if os.path.exists(path):
        return kzg.SRS.load(path, device=device)
    srs = _generate_srs(degree, device)
    os.makedirs(params_dir, exist_ok=True)
    srs.save(path)
    return srs


def load_params_map(params_dir: str, degrees: list[int], device=None) -> dict[int, kzg.SRS]:
    return {d: load_params(params_dir, d, device) for d in degrees}


class _KeygenCache:
    """(circuit-shape id) -> (pk, vk); keygen is deterministic per shape."""

    def __init__(self, assets_dir: str = ""):
        self._cache: dict[str, tuple] = {}
        self.assets_dir = assets_dir

    def get(self, srs, k, circuit, shape_id: str):
        key = f"{shape_id}_k{k}"
        if key not in self._cache:
            pk, vk = keygen(srs, k, circuit)
            # the copies were keygen's input (its permutation is in pk now):
            # a layer circuit's are millions of tuples that the vk would
            # otherwise hold, and every later collection would walk, for as
            # long as the registry keeps it
            vk.cs.copies, vk.cs._copy_set = [], set()
            register_vk(vk, self.assets_dir)
            self._cache[key] = (pk, vk)
        return self._cache[key]


class ChunkProver:
    def __init__(self, params_map: dict[int, kzg.SRS], assets_dir: str = "", device=None):
        self.device = resolve_device(device)
        self.params_map = params_map
        self.assets_dir = assets_dir
        self._kg = _KeygenCache(assets_dir)

    @classmethod
    def from_params_and_assets(cls, params_map, assets_dir: str = "", device=None) -> "ChunkProver":
        return cls(params_map, assets_dir, device)

    def _srs_for(self, k: int) -> kzg.SRS:
        if k in self.params_map:
            return self.params_map[k]
        # downsizing a ceremony SRS costs a group iNTT; generated (toy) SRS
        # are cheaper to regenerate at the exact degree
        srs = _generate_srs(k, self.device)
        self.params_map[k] = srs
        return srs

    def gen_halo2_chunk_proof(
        self,
        task: ChunkProvingTask,
        chunk_id: str | None = None,
        inner_id: str | None = None,
        output_dir: str | None = None,
    ) -> ChunkProofV2:
        assert not task.is_empty()
        name = chunk_id or task.identifier()
        wb = chunk_trace_to_witness_block(task.block_traces)
        chunk_info = ChunkInfo.from_witness_block(wb)
        row_usages = [u.to_json() for u in calculate_row_usage_of_witness_block(wb)]

        # loud under-capacity check: an explicit sig cap below demand means
        # unverified signatures — say so
        sig_cap = os.environ.get("SPT_SIG_CAP")
        n_sigs = len(wb.sig_events())
        if sig_cap is not None and int(sig_cap) < n_sigs:
            log.warning(
                "SPT_SIG_CAP=%s below witness demand %d: %d signature(s) "
                "will NOT be ECDSA-verified in-circuit",
                sig_cap, n_sigs, n_sigs - int(sig_cap),
            )

        # inner: ScrollSuperCircuit
        circuit = ScrollSuperCircuit.new_from_block(wb)
        k_in = circuit.min_k()
        srs = self._srs_for(k_in)
        pk, vk = self._kg.get(srs, k_in, circuit, f"inner_{inner_id or 'super'}")
        inst = [chunk_instance(wb)]
        mo = _ladder_multiopen()
        log.info("chunk %s: inner proof at k=%d (%s)", name, k_in, mo)
        inner_proof = plonk_prove(srs, pk, circuit, inst, multiopen=mo)
        layers = [
            ProofPayload(
                proof=inner_proof,
                instances=inst[0],
                protocol=protocol_from_vk(vk, len(inst[0]), multiopen=mo),
                vk_id=hex(vk.transcript_repr()),
            )
        ]
        layer_vk = vk
        for layer in (1, 2):
            payload, layer_vk, _circuit = self._compress_layer(layers[-1], layer_vk, layer, name, mo)
            layers.append(payload)

        proof = ChunkProofV2(
            ChunkProofInner(layers=layers, chunk_info_=chunk_info, row_usages=row_usages)
        )
        if output_dir:
            proof.dump(output_dir, name)
        return proof

    def _compress_layer(self, prev: ProofPayload, prev_vk, layer: int, name: str, mo: str,
                        seed: bytes | None = None):
        """Layer `layer` (1 or 2) of the chunk ladder: a VerifierCircuit that
        verifies `prev` in constraints, the deferred pairing carried as the
        12-cell KZG accumulator (reference layer1/layer2 CompressionCircuit
        semantics, SURVEY.md section 3.1; accumulator_indices per
        release-v0.13.1/chunk.protocol); layer 2 folds layer 1's accumulator.
        Keygen is cached per shape. A fixed `seed` (deterministic blinding)
        is for tests only. Returns (payload, vk, circuit)."""
        comp = VerifierCircuit(
            prev_vk, prev.proof, prev.instances,
            inner_has_acc=(layer == 2),
            inner_multiopen=prev.protocol.get("multiopen", "gwc"),
        )
        k_c = comp.min_k()
        log.info("chunk %s: layer%d verifier circuit: %d rows, k=%d", name, layer, comp._rows, k_c)
        srs_c = self._srs_for(k_c)
        log.info("chunk %s: layer%d srs ready", name, layer)
        pk_c, vk_c = self._kg.get(
            srs_c, k_c, comp,
            _mo_tag(f"layer{layer}_{hex(prev_vk.transcript_repr())[:18]}", mo),
        )
        log.info("chunk %s: layer%d keygen done", name, layer)
        ci = comp.instance_for()
        proof_c = plonk_prove(srs_c, pk_c, comp, ci, seed=seed, multiopen=mo)
        vk_c.domain.release()  # rebuilt by the next prove of this shape
        log.info("chunk %s: layer%d proved", name, layer)
        payload = ProofPayload(
            proof=proof_c,
            instances=ci[0],
            protocol=protocol_from_vk(vk_c, len(ci[0]), multiopen=mo),
            vk_id=hex(vk_c.transcript_repr()),
        )
        return payload, vk_c, comp


class ChunkVerifier:
    def __init__(self, params_map: dict[int, kzg.SRS], assets_dir: str = "", device=None):
        self.device = resolve_device(device)
        self.params_map = params_map
        self.assets_dir = assets_dir

    @classmethod
    def from_params_and_assets(cls, params_map, assets_dir: str = "", device=None) -> "ChunkVerifier":
        return cls(params_map, assets_dir, device)

    def _srs_for(self, k: int) -> kzg.SRS:
        return ChunkProver._srs_for(self, k)

    def verify_chunk_proof(self, proof: ChunkProofV2) -> bool:
        """O(1) recursive verification: ONE SNARK check of the outermost
        (layer2) verifier-circuit proof plus ONE pairing on its 12-cell KZG
        accumulator (`_verify_outer`). Layer2 verified inner proofs
        in-circuit, so this transitively attests to layer1 and the inner
        super-circuit proof — no layer walk (reference semantics:
        ChunkVerifier::verify_chunk_proof checks only the layer-2 proof,
        SURVEY.md section 3.1). Then the chunk binding."""
        l2 = proof.inner.layers[-1]
        if not self._verify_outer(l2):
            return False
        return self._check_chunk_binding(
            list(l2.instances[ACC_CELLS:]), proof.inner.chunk_info_
        )

    def _verify_outer(self, l2: ProofPayload) -> bool:
        """The SNARK check of a layer-2 payload against its registered vk,
        and the pairing on its accumulator cells."""
        k = l2.protocol["domain"]["k"]
        srs = self._srs_for(k)
        # fail closed: the expected layer2 vk must come from the registry or
        # serialized assets; a self-supplied vk would let a prover verify
        # against a circuit that doesn't actually check anything
        vk = load_vk(l2.vk_id, self.assets_dir)
        if vk is None:
            log.error(
                "layer2 vk %s unavailable (registry/assets_dir=%r); rejecting",
                l2.vk_id, self.assets_dir,
            )
            return False
        if hex(vk.transcript_repr()) != l2.vk_id:
            log.error("layer2 vk digest mismatch")
            return False
        if not plonk_verify(
            srs, vk, [l2.instances], l2.proof,
            multiopen=l2.protocol.get("multiopen", "gwc"),
        ):
            log.error("layer2 SNARK verification failed")
            return False
        try:
            lhs, rhs = acc_from_limbs(l2.instances[:ACC_CELLS])
        except AssertionError:
            log.error("layer2 accumulator cells malformed")
            return False
        if not check_accumulator(srs, lhs, rhs):
            log.error("deferred KZG accumulator pairing failed")
            return False
        return True

    def _check_chunk_binding(self, passthrough: list[int], chunk_info) -> bool:
        """Layer2's pass-through instances must equal the inner chunk
        instance derived from the claimed chunk_info."""
        from ..witness.block import WitnessBlock

        wb = WitnessBlock(
            chain_id=chunk_info.chain_id,
            prev_state_root=chunk_info.prev_state_root,
            post_state_root=chunk_info.post_state_root,
            withdraw_root=chunk_info.withdraw_root,
            tx_bytes=chunk_info.tx_bytes,
        )
        want = chunk_instance(wb)
        if passthrough[:7] != want[:7]:
            log.error("chunk pass-through/chunk_info mismatch")
            return False
        dh = int(chunk_info.data_hash, 16)
        if passthrough[7:9] != [(dh >> 128) % FR_MOD, dh & ((1 << 128) - 1)]:
            log.error("chunk data_hash/chunk_info mismatch")
            return False
        return True


# chunk layer2 instance offsets: [12 accumulator cells || chain_id,
# prev_hi, prev_lo, post_hi, post_lo, withdraw_hi, withdraw_lo, dh_hi,
# dh_lo] (VerifierCircuit pass-through of zkevm.chunk_instance)
_L2_CHAIN_ID = ACC_CELLS
_L2_PREV = ACC_CELLS + 1
_L2_POST = ACC_CELLS + 3
_L2_DH = ACC_CELLS + 7

# batch layer4 instance offsets: [12 fresh acc || digest || batch_hash
# hi/lo, z hi/lo, y hi/lo || chain_id, first_prev hi/lo, last_post hi/lo,
# per-chunk dh...] (VerifierCircuit pass-through of the layer3
# AggregationCircuit instance)
_L4_DIGEST = ACC_CELLS
_L4_BH = ACC_CELLS + 1
_L4_Z = ACC_CELLS + 3
_L4_Y = ACC_CELLS + 5
_L4_BLOB = ACC_CELLS + 7      # in-circuit blob-coefficient digest cell
_L4_CHAIN_ID = ACC_CELLS + 8
_L4_FIRST_PREV = ACC_CELLS + 9
_L4_LAST_POST = ACC_CELLS + 11
_L4_DH0 = ACC_CELLS + 13


def _chunk_chain_links(n: int) -> list[tuple[int, int, int, int]]:
    """post_state_root(i) == prev_state_root(i+1), hi and lo halves."""
    links = []
    for i in range(n - 1):
        links.append((i, _L2_POST, i + 1, _L2_PREV))
        links.append((i, _L2_POST + 1, i + 1, _L2_PREV + 1))
    return links


def _batch_expose(n: int) -> list[tuple[int, int]]:
    """Statement cells the batch PI carries: chain id, boundary state
    roots, and every chunk's data hash (bound to the header's data_hash
    by the verifier via keccak)."""
    exp = [
        (0, _L2_CHAIN_ID),
        (0, _L2_PREV), (0, _L2_PREV + 1),
        (n - 1, _L2_POST), (n - 1, _L2_POST + 1),
    ]
    for i in range(n):
        exp.append((i, _L2_DH))
        exp.append((i, _L2_DH + 1))
    return exp


def _bundle_links(n: int) -> list[tuple[int, int, int, int]]:
    """last_post_state_root(batch i) == first_prev_state_root(batch i+1)."""
    links = []
    for i in range(n - 1):
        links.append((i, _L4_LAST_POST, i + 1, _L4_FIRST_PREV))
        links.append((i, _L4_LAST_POST + 1, i + 1, _L4_FIRST_PREV + 1))
    return links


def _bundle_expose(n: int) -> list[tuple[int, int]]:
    exp = [
        (0, _L4_FIRST_PREV), (0, _L4_FIRST_PREV + 1),
        (n - 1, _L4_LAST_POST), (n - 1, _L4_LAST_POST + 1),
    ]
    for i in range(n):
        exp.append((i, _L4_BH))
        exp.append((i, _L4_BH + 1))
    return exp


def _header_context(header) -> list[int]:
    """[batch_hash hi/lo, z hi/lo, y hi/lo]: the header values the layer-3
    circuit binds in its digest and exposes after it."""
    bh = header.batch_hash()
    z, y = header.blob_data_proof
    m = (1 << 128) - 1
    return [
        int.from_bytes(bh[:16], "big"), int.from_bytes(bh[16:], "big"),
        z >> 128, z & m, y >> 128, y & m,
    ]


class BatchProver:
    """layer3 AggregationCircuit (in-circuit verification of every chunk
    layer2 SNARK and of the blob's evaluation at the header's (z, y)) +
    layer4 verifier-compression -> BatchProofV2; layer5 AggregationCircuit
    over batch layer4s + layer6 (Keccak transcript, GWC) -> BundleProof,
    with the release artifacts and the in-EVM verification of the bundle
    (reference prove.rs:57-109, SURVEY.md section 3.2). Runs on `device`
    (the card unless the caller passes device="cpu"); an SRS the params map
    lacks is generated there."""

    def __init__(self, params_map: dict[int, kzg.SRS], assets_dir: str = "", device=None):
        self.device = resolve_device(device)
        self.params_map = params_map
        self.assets_dir = assets_dir
        self._kg = _KeygenCache(assets_dir)

    @classmethod
    def from_params_and_assets(cls, params_map, assets_dir: str = "", device=None) -> "BatchProver":
        return cls(params_map, assets_dir, device)

    _srs_for = ChunkProver._srs_for

    def _prove_circuit(
        self, circuit, shape_id: str, transcript_cls=None,
        multiopen: str = "gwc", seed: bytes | None = None,
    ):
        """min_k, the SRS, keygen (cached per shape), the host instance and
        the prove of one layer circuit. A fixed `seed` (deterministic
        blinding) is for tests only. Returns (payload, vk)."""
        from ..proof_system.transcript import PoseidonTranscript

        layer = shape_id.split("_")[0]
        k = circuit.min_k()
        log.info("batch: %s circuit: %d rows, k=%d", layer, circuit._rows, k)
        srs = self._srs_for(k)
        log.info("batch: %s srs ready", layer)
        pk, vk = self._kg.get(srs, k, circuit, _mo_tag(shape_id, multiopen))
        log.info("batch: %s keygen done", layer)
        inst = circuit.instance_for()
        proof = plonk_prove(
            srs, pk, circuit, inst,
            transcript_cls=transcript_cls or PoseidonTranscript,
            seed=seed, multiopen=multiopen,
        )
        vk.domain.release()  # rebuilt by the next prove of this shape
        log.info("batch: %s proved", layer)
        payload = ProofPayload(
            proof=proof,
            instances=inst[0],
            protocol=protocol_from_vk(vk, len(inst[0]), multiopen=multiopen),
            vk_id=hex(vk.transcript_repr()),
        )
        return payload, vk

    def gen_batch_proof(self, task, output_dir: str | None = None):
        return self._gen_batch_proof(task, output_dir)

    def _gen_batch_proof(self, task, output_dir: str | None = None, seed: bytes | None = None):
        """gen_batch_proof's body; a fixed `seed` (tests only) blinds layer
        3 with seed + bytes([3]) and layer 4 with seed + bytes([4])."""
        from ..aggregator.constants import MAX_AGG_SNARKS
        from .aggregation_circuit import AggregationCircuit
        from .proofs import BatchProofInner, BatchProofV2

        header = task.batch_header
        # chunk chaining sanity (the AggregationCircuit links also
        # constrain the roots in-circuit)
        infos = [p.inner.chunk_info() for p in task.chunk_proofs]
        for a, b in zip(infos, infos[1:]):
            assert a.post_state_root == b.prev_state_root, "chunk chain broken"
        assert 0 < len(task.chunk_proofs) <= MAX_AGG_SNARKS
        inners = []
        for p in task.chunk_proofs:
            l2 = p.inner.layers[-1]
            vk2 = load_vk(l2.vk_id, self.assets_dir)
            assert vk2 is not None, f"chunk layer2 vk {l2.vk_id} unavailable"
            inners.append((vk2, l2.proof, list(l2.instances)))
        n = len(inners)
        context = _header_context(header)
        log.info("batch %d: layer3 aggregation over %d chunks", header.batch_index, n)
        # layer3: one VerifierGadget per chunk layer2 SNARK, accumulators
        # mu-folded, state-root chaining linked in-circuit, statement cells
        # exposed in the PI (reference BatchCircuit semantics, SURVEY.md
        # section 3.2); blob consistency: the barycentric evaluation of the
        # blob polynomial at the header's (z, y) is constrained in-circuit
        # and the coefficient digest exposed; SPT_BLOB_WIDTH shrinks the
        # domain for test tiers only
        blob_width = int(os.environ.get("SPT_BLOB_WIDTH", "4096"))
        mo = _ladder_multiopen()
        inner_mos = {
            p.inner.layers[-1].protocol.get("multiopen", "gwc")
            for p in task.chunk_proofs
        }
        assert len(inner_mos) == 1, f"mixed chunk multiopen schemes: {inner_mos}"
        layer3, vk3 = self._prove_circuit(
            AggregationCircuit(
                inners, context, inners_have_acc=True,
                links=_chunk_chain_links(n),
                expose=_batch_expose(n),
                blob_bytes=task.blob_bytes,
                blob_width=blob_width,
                inner_multiopen=inner_mos.pop(),
            ),
            f"layer3_{'_'.join(hex(vk.transcript_repr())[:10] for vk, _, _ in inners)}",
            multiopen=mo,
            seed=None if seed is None else seed + bytes([3]),
        )
        # layer4: in-circuit verification of layer3 with its accumulator
        # folded forward, deferred pairing exposed as the fresh 12 cells
        layer4, _vk4 = self._prove_circuit(
            VerifierCircuit(
                vk3, layer3.proof, layer3.instances, inner_has_acc=True,
                inner_multiopen=mo,
            ),
            f"layer4_{hex(vk3.transcript_repr())[:18]}",
            multiopen=mo,
            seed=None if seed is None else seed + bytes([4]),
        )
        proof = BatchProofV2(
            BatchProofInner(
                layers=[layer3, layer4],
                batch_hash=header.batch_hash(),
                batch_header=header,
                blob_bytes=task.blob_bytes,
                chunk_infos=infos,
            )
        )
        if output_dir:
            proof.dump(output_dir, str(header.batch_index))
        return proof

    def gen_bundle_proof(self, task, output_dir: str | None = None):
        from ..proof_system.transcript import KeccakTranscript
        from .aggregation_circuit import AggregationCircuit
        from .proofs import BundleProof

        headers = [p.inner.batch_header for p in task.batch_proofs]
        for a, b in zip(headers, headers[1:]):
            assert b.parent_batch_hash == a.batch_hash(), "batch chain broken"
        inners = []
        for p in task.batch_proofs:
            l4 = p.inner.layers[-1]
            vk4 = load_vk(l4.vk_id, self.assets_dir)
            assert vk4 is not None, f"batch layer4 vk {l4.vk_id} unavailable"
            inners.append((vk4, l4.proof, list(l4.instances)))
        n = len(inners)
        first_parent = headers[0].parent_batch_hash
        last_hash = headers[-1].batch_hash()
        context = [
            int.from_bytes(first_parent[:16], "big"),
            int.from_bytes(first_parent[16:], "big"),
            int.from_bytes(last_hash[:16], "big"),
            int.from_bytes(last_hash[16:], "big"),
            n,
        ]
        log.info("bundle: layer5 aggregation over %d batches", n)
        # layer5: in-circuit verification of every batch layer4 SNARK with
        # cross-batch state-root chaining linked in-circuit (reference
        # RecursionCircuit role)
        mo = _ladder_multiopen()
        l4_mos = {
            p.inner.layers[-1].protocol.get("multiopen", "gwc")
            for p in task.batch_proofs
        }
        assert len(l4_mos) == 1, f"mixed batch multiopen schemes: {l4_mos}"
        layer5, vk5 = self._prove_circuit(
            AggregationCircuit(
                inners, context, inners_have_acc=True,
                links=_bundle_links(n),
                expose=_bundle_expose(n),
                inner_multiopen=l4_mos.pop(),
            ),
            f"layer5_{'_'.join(hex(vk.transcript_repr())[:10] for vk, _, _ in inners)}",
            multiopen=mo,
        )
        # layer6: in-circuit verification of layer5; the outer proof itself
        # uses the EVM-facing Keccak transcript AND the GWC multiopen the
        # generated verifier bytecode re-derives (the rest of the ladder
        # proves SHPLONK — _ladder_multiopen)
        layer6, _vk6 = self._prove_circuit(
            VerifierCircuit(
                vk5, layer5.proof, layer5.instances, inner_has_acc=True,
                inner_multiopen=mo,
            ),
            f"layer6_{hex(vk5.transcript_repr())[:18]}",
            transcript_cls=KeccakTranscript,
            multiopen="gwc",
        )
        proof = BundleProof(layers=[layer5, layer6])
        if output_dir:
            proof.dump(output_dir, "recursion")
            self._dump_release_artifacts(proof, layer6, output_dir)
        return proof

    def _dump_release_artifacts(self, proof, layer6, output_dir: str):
        """Release-artifact protocol (reference release.sh:9-41 +
        SCROLL_PROVER_DUMP_YUL, Makefile:51): evm_verifier.{yul,bin},
        pi_bundle_recursion.data, proof_bundle_recursion.data."""
        from ..evm.full_verifier import gen_full_verifier
        from ..evm.harness import DEPLOYMENT_CODE_FILENAME
        from .proofs import encode_instances

        k = layer6.protocol["domain"]["k"]
        srs = self._srs_for(k)
        with open(os.path.join(output_dir, "pi_bundle_recursion.data"), "wb") as fh:
            fh.write(encode_instances(layer6.instances))
        with open(os.path.join(output_dir, "proof_bundle_recursion.data"), "wb") as fh:
            fh.write(layer6.proof)
        # the full in-bytecode verifier: transcript + GWC fold + accumulator
        # fold + pairing, with the YUL emitted as the auditable source
        # artifact. The layer6 vk was registered by keygen.
        vk = load_vk(layer6.vk_id, self.assets_dir)
        assert vk is not None, "layer6 vk must be registered"
        bytecode, yul = gen_full_verifier(
            vk, srs, len(layer6.instances), has_accumulator=True
        )
        with open(os.path.join(output_dir, DEPLOYMENT_CODE_FILENAME), "wb") as fh:
            fh.write(bytecode)
        with open(os.path.join(output_dir, "evm_verifier.yul"), "w") as fh:
            fh.write(yul)

    def evm_verify_bundle(self, proof, output_dir: str) -> int | None:
        """Execute the bundle proof verification ENTIRELY inside the EVM:
        the contract re-derives the transcript and multiopen fold from
        calldata = [instances || proof] — no host verifier in the loop
        (reference flow: EVMVerifier::from_dirs + verify_evm_proof,
        prove.rs:103; calldata splice per unit_tests.rs:32)."""
        from ..evm.full_verifier import proof_calldata
        from ..evm.harness import EVMVerifier

        l6 = proof.layers[-1]
        calldata = proof_calldata(list(l6.instances), l6.proof)
        return EVMVerifier.from_dirs(output_dir).verify_evm_proof(calldata)


class BatchVerifier:
    def __init__(self, params_map: dict[int, kzg.SRS], assets_dir: str = "", device=None):
        self.device = resolve_device(device)
        self.params_map = params_map
        self.assets_dir = assets_dir
        self._kg = _KeygenCache(assets_dir)

    @classmethod
    def from_params_and_assets(cls, params_map, assets_dir: str = "", device=None) -> "BatchVerifier":
        return cls(params_map, assets_dir, device)

    _srs_for = ChunkProver._srs_for

    def _verify_layer(
        self, payload: ProofPayload, circuit=None, transcript_cls=None,
        folded_acc: bool = False,
    ) -> bool:
        from ..proof_system.transcript import PoseidonTranscript

        k = payload.protocol["domain"]["k"]
        srs = self._srs_for(k)
        vk = load_vk(payload.vk_id, self.assets_dir)
        if vk is None and circuit is not None:
            _pk, vk = self._kg.get(srs, k, circuit, f"verify_{payload.vk_id}")
        if vk is None:
            log.error("vk %s unavailable; rejecting (fail closed)", payload.vk_id)
            return False
        if hex(vk.transcript_repr()) != payload.vk_id:
            log.error("vk mismatch")
            return False
        fold = None
        if folded_acc:
            try:
                fold = acc_from_limbs(list(payload.instances[:ACC_CELLS]))
            except AssertionError:
                log.error("accumulator cells malformed")
                return False
        return plonk_verify(
            srs, vk, [payload.instances], payload.proof,
            transcript_cls=transcript_cls or PoseidonTranscript,
            fold_accumulator=fold,
            multiopen=payload.protocol.get("multiopen", "gwc"),
        )

    def verify_batch_proof(self, proof) -> bool:
        """O(1) fully-recursive verification: ONE layer4 SNARK check with
        its 12-cell accumulator folded into the pairing. Layer4 verified
        layer3 in-circuit; layer3 (AggregationCircuit) verified EVERY chunk
        layer2 SNARK in-circuit and folded their accumulators — so this
        single check transitively attests to every chunk ladder down to the
        inner super-circuit proofs (reference BatchVerifier semantics,
        prove.rs:75-80)."""
        from ..hashes.keccak import keccak256

        l3, l4 = proof.inner.layers
        if list(l4.instances[ACC_CELLS:]) != list(l3.instances[ACC_CELLS:]):
            log.error("layer4 pass-through mismatch")
            return False
        if not self._verify_layer(l4, folded_acc=True):
            log.error("layer4 verification failed")
            return False
        header = proof.inner.batch_header
        if header is not None:
            inst = list(l4.instances)
            bh = header.batch_hash()
            if bh != proof.inner.batch_hash:
                log.error("batch hash mismatch")
                return False
            if inst[_L4_BH:_L4_BH + 6] != _header_context(header):
                log.error("layer3 header binding mismatch")
                return False
            # blob byte binding: the in-circuit coefficient digest must be
            # reproducible from the ACTUAL blob bytes (fail-closed — a
            # proof without blob bytes does not verify)
            if proof.inner.blob_bytes is None:
                log.error("batch proof missing blob bytes")
                return False
            blob_width = int(os.environ.get("SPT_BLOB_WIDTH", "4096"))
            from .aggregation_circuit import AggregationCircuit as _AC

            want_blob = _AC.host_blob_digest(proof.inner.blob_bytes, blob_width)
            if inst[_L4_BLOB] != want_blob:
                log.error("blob coefficient digest mismatch")
                return False
            # blob payload <-> chunk statement binding: decode the blob
            # envelope, slice the per-chunk tx-byte segments, and require
            # each to equal the declared chunk's payload whose data_hash
            # is the exposed (in-circuit-verified) statement cell — so a
            # blob carrying different L2 data than the proven chunks fails
            # verification even though both are internally consistent
            from ..aggregator.batch_data import BatchData as _BD
            from ..aggregator.batch_data import decode_blob_bytes

            infos = proof.inner.chunk_infos
            if infos is None:
                log.error("batch proof missing chunk infos")
                return False
            try:
                bd = _BD.parse(decode_blob_bytes(proof.inner.blob_bytes))
            except (AssertionError, ValueError) as e:
                log.error("blob payload malformed: %s", e)
                return False
            if bd.num_valid_chunks != len(infos):
                log.error("blob chunk count != aggregated chunk count")
                return False
            dh_pairs = list(zip(inst[_L4_DH0::2], inst[_L4_DH0 + 1::2]))
            if len(dh_pairs) < len(infos):
                log.error("fewer exposed data hashes than chunks")
                return False
            for i, ci in enumerate(infos):
                if bd.chunk_data[i] != bytes(ci.tx_bytes):
                    log.error("blob payload segment %d != chunk tx bytes", i)
                    return False
                dh = int(ci.data_hash, 16)
                if dh_pairs[i] != (dh >> 128, dh & ((1 << 128) - 1)):
                    log.error("chunk %d data_hash != exposed statement", i)
                    return False
            # the exposed per-chunk data hashes must reproduce the header's
            # data_hash = keccak(dh_0 || ... || dh_{n-1}) — this ties the
            # header to the statements whose proofs were verified in-circuit
            dh_cells = inst[_L4_DH0:]
            if len(dh_cells) < 2 or len(dh_cells) % 2:
                log.error("malformed exposed data-hash cells")
                return False
            preimage = b"".join(
                ((hi << 128) | lo).to_bytes(32, "big")
                for hi, lo in zip(dh_cells[0::2], dh_cells[1::2])
            )
            if keccak256(preimage) != header.data_hash:
                log.error("exposed chunk data hashes != header data_hash")
                return False
        return True

    def verify_bundle_proof(self, proof) -> bool:
        """O(1): ONE layer6 SNARK (Keccak transcript) + ONE accumulator
        pairing transitively verifies layer5's in-circuit aggregation of
        every batch proof, and below them every chunk and inner proof."""
        from ..proof_system.transcript import KeccakTranscript

        l5, l6 = proof.layers
        if list(l6.instances[ACC_CELLS:]) != list(l5.instances[ACC_CELLS:]):
            log.error("layer6 pass-through mismatch")
            return False
        if not self._verify_layer(
            l6, transcript_cls=KeccakTranscript, folded_acc=True
        ):
            return False
        # bundle PI sanity: [digest, first_parent hi/lo, last_hash hi/lo, n,
        # first_prev hi/lo, last_post hi/lo, batch_hash_i hi/lo ...]; the
        # last exposed batch hash must equal the declared last_hash context
        inst = list(l6.instances)
        base = ACC_CELLS + 1  # after digest
        try:
            n = inst[base + 4]
            last_bh_off = base + 5 + 4 + 2 * (n - 1)
            if inst[last_bh_off:last_bh_off + 2] != inst[base + 2:base + 4]:
                log.error("last exposed batch hash != declared last_hash")
                return False
        except (IndexError, TypeError):
            log.error("malformed bundle instance layout")
            return False
        return True


# in-process vk registry: keygen publishes vks here so verifiers can check
# inner proofs without re-synthesizing the witness-dependent circuit shape.
# With an assets_dir, vks are ALSO serialized to disk (reference parity:
# vk_chunk_*.vkey dumped into the output/assets dir, SURVEY.md section 5
# checkpoint/resume) so a fresh process can verify from disk alone.
_VK_REGISTRY: dict[str, object] = {}


def register_vk(vk, assets_dir: str = "") -> None:
    vk_id = hex(vk.transcript_repr())
    _VK_REGISTRY[vk_id] = vk
    if assets_dir:
        os.makedirs(assets_dir, exist_ok=True)
        path = os.path.join(assets_dir, f"vk_{vk_id}.vkey")
        if not os.path.exists(path):
            with open(path, "wb") as fh:
                fh.write(vk.to_bytes())


def load_vk(vk_id: str, assets_dir: str = ""):
    """Resolve a vk by transcript-repr id: in-process registry first, then
    the assets dir. Returns None when unavailable (callers MUST fail
    closed)."""
    vk = _VK_REGISTRY.get(vk_id)
    if vk is not None:
        return vk
    if assets_dir:
        path = os.path.join(assets_dir, f"vk_{vk_id}.vkey")
        if os.path.exists(path):
            from ..proof_system.plonk.keygen import VerifyingKey

            with open(path, "rb") as fh:
                vk = VerifyingKey.from_bytes(fh.read())
            if hex(vk.transcript_repr()) == vk_id:
                _VK_REGISTRY[vk_id] = vk
                return vk
            log.error("vk file %s fails its self-digest", path)
    return None


def _downsized(srs: kzg.SRS, k: int) -> kzg.SRS:
    """srs.downsize(k), once per (SRS object, k). No proving path calls it:
    each degree's SRS is made by `_generate_srs`."""
    cache_key = (id(srs), k)
    if cache_key not in _DOWNSIZE_CACHE:
        _DOWNSIZE_CACHE[cache_key] = srs.downsize(k)
    return _DOWNSIZE_CACHE[cache_key]


_DOWNSIZE_CACHE: dict = {}


def apply_production_cap_profile(traces) -> dict:
    """Default every unset SPT_*_CAP to the WITNESS DEMAND of `traces`.

    The production profile: an out-of-the-box trace_prover proof constrains
    every signature / keccak / mpt / precompile event — matching the
    reference's full super circuit with no opt-outs
    (integration/src/mock.rs:22). Explicitly-set caps win (tuned production
    runs, test shrink); the chunk prover warns loudly when an explicit sig
    cap is below demand. Returns the resolved profile for logging.
    """
    wb = chunk_trace_to_witness_block(traces)
    demands = {
        "SPT_SIG_CAP": len(wb.sig_events()),
        "SPT_KECCAK_CAP": 1_000_000,
        "SPT_MPT_CAP": 1_000_000,
        "SPT_SHA256_CAP": 1_000_000,
        "SPT_ECC_CAP": len(wb.ecc_events),
        "SPT_MODEXP_CAP": len(wb.modexp_raw),
    }
    resolved = {}
    for env_name, demand in demands.items():
        cur = os.environ.get(env_name)
        if cur is None:
            os.environ[env_name] = str(demand)
            resolved[env_name] = demand
        else:
            resolved[env_name] = int(cur)
    log.info("production cap profile: %s", resolved)
    return resolved
