"""ChunkProver / ChunkVerifier + params io (the chunk side of the facade).

API parity with the reference prover crate (SURVEY.md section 2.3):
`ChunkProver::from_params_and_assets` + `gen_halo2_chunk_proof(task, id,
inner_id, output_dir)` (integration/src/prove.rs:30,38), the verifier
counterpart (prove.rs:50-53), `Prover::load_params_map(dir, degrees)`
(bin/src/trace_prover.rs:35-36), CHUNK_PROVER_DEGREES.

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
