"""Port parity for the aggregator's host code (aggregator/: blob codec, batch
data and header, the sponge BatchCircuit and RecursionCircuit) and the
batch side of integration/prove.py: the twin of tests/test_aggregation.py's
fast cases. The same inputs go through both packages; blob bytes, header
hashes and JSON, blob evaluations and mock-prover verdicts are equal,
exactly (integers and bytes)."""
import pytest
import torch

import tests.torch_native_cases  # noqa: F401  (both packages' native libraries, built once under a lock)
from scroll_prover_tpu import aggregator as jagg
from scroll_prover_tpu.aggregator import blob as jblob
from scroll_prover_tpu.aggregator import circuits as jcircuits
from scroll_prover_tpu.integration import prove as jintegration
from scroll_prover_tpu.proof_system.plonk import MockProver as JMockProver
from scroll_prover_tpu.prover import chunk_info as jci
from scroll_prover_tpu_torch import aggregator as tagg
from scroll_prover_tpu_torch.aggregator import blob as tblob
from scroll_prover_tpu_torch.aggregator import circuits as tcircuits
from scroll_prover_tpu_torch.integration import prove as tintegration
from scroll_prover_tpu_torch.proof_system.plonk.mock import MockProver as TMockProver
from scroll_prover_tpu_torch.prover import chunk_info as tci

torch.set_num_threads(2)

PKGS = {"jax": (jagg, jblob, jcircuits, jintegration, JMockProver, jci),
        "torch": (tagg, tblob, tcircuits, tintegration, TMockProver, tci)}


def _chunk_info(ci_mod, i=0, prev="0x" + "aa" * 32, post="0x" + "bb" * 32):
    return ci_mod.ChunkInfo(
        chain_id=534352,
        prev_state_root=prev,
        post_state_root=post,
        withdraw_root="0x" + "cc" * 32,
        data_hash="0x" + "dd" * 32,
        tx_bytes=bytes([i]) * (50 + i),
    )


def _both(fn):
    """fn(package modules) on both packages; asserts the results are equal
    and returns the port's."""
    got = {name: fn(*mods) for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


@pytest.mark.parametrize("compress", [None, False])
def test_blob_codec_roundtrip(compress):
    """BatchData bytes and the enveloped blob (zstd when the codec is
    available, and forced raw) are equal, and decode back."""
    def run(agg, _blob, _c, _i, _m, ci):
        infos = [_chunk_info(ci, 0), _chunk_info(ci, 1)]
        pad = [ci.mock_padded_chunk_info_for_testing(infos[-1])] * (agg.MAX_AGG_SNARKS - 2)
        raw = agg.BatchData.new(2, infos + pad).get_batch_data_bytes()
        assert raw[0] == 0 and raw[1] == 2
        assert len(raw) == 2 + 4 * agg.MAX_AGG_SNARKS + 50 + 51
        blob = agg.get_blob_bytes(raw, compress=compress)
        assert agg.decode_blob_bytes(blob) == raw
        assert len(blob) <= agg.N_BLOB_BYTES
        parsed = agg.BatchData.parse(raw)
        return raw, blob, parsed.num_valid_chunks, parsed.chunk_sizes, parsed.chunk_data

    raw, blob, n, _sizes, _data = _both(run)
    assert n == 2
    if compress is False:
        assert blob[0] == 0 and blob[1:] == raw


def test_zstd_availability_matches():
    from scroll_prover_tpu.native import zstd_codec as jz
    from scroll_prover_tpu_torch.native import zstd_codec as tz

    assert tz.zstd_available() == jz.zstd_available()


def test_barycentric_matches_jax():
    """The brp domain and the barycentric evaluation are equal, off and on
    the domain, and linear."""
    coeffs = [0] * 4096
    coeffs[0], coeffs[1], coeffs[7] = 11, 22, 33
    coeffs[4095] = tblob.BLS_MODULUS - 5
    assert tblob._domain() == jblob._domain()
    for z in (0x1234567890ABCDEF, tblob.BLS_MODULUS - 3, tblob._domain()[7]):
        y = tblob.barycentric_evaluate(coeffs, z)
        assert y == jblob.barycentric_evaluate(coeffs, z)
    assert tblob.barycentric_evaluate(coeffs, tblob._domain()[7]) == 33
    y = tblob.barycentric_evaluate(coeffs, 0x1234567890ABCDEF)
    y2 = tblob.barycentric_evaluate([2 * c % tblob.BLS_MODULUS for c in coeffs], 0x1234567890ABCDEF)
    assert y2 == 2 * y % tblob.BLS_MODULUS
    blob = bytes(range(256)) * 40
    assert tblob.blob_to_coefficients(blob) == jblob.blob_to_coefficients(blob)
    assert tblob.coefficients_to_blob(tblob.blob_to_coefficients(blob)) == \
        jblob.coefficients_to_blob(jblob.blob_to_coefficients(blob))


def test_batch_header_hash_and_json():
    """construct_from_chunks (the real BLS12-381 commitment, the challenge
    and the evaluation), the hash and the JSON are equal; JSON round trips."""
    def run(agg, _blob, _c, _i, _m, ci):
        infos = [_chunk_info(ci, 0)]
        blob = agg.get_blob_bytes(agg.BatchData.new(1, infos).get_batch_data_bytes(), compress=False)
        h = agg.BatchHeader.construct_from_chunks(
            version=4, batch_index=7, l1_message_popped=0, total_l1_message_popped=5,
            parent_batch_hash=b"\x11" * 32, last_block_timestamp=1234,
            chunk_infos=infos, blob_bytes=blob,
        )
        bh = h.batch_hash()
        rt = agg.BatchHeader.from_json(h.to_json())
        assert rt.batch_hash() == bh and rt.blob_data_proof == h.blob_data_proof
        return bh, h.to_json(), h.encode()

    bh, _json, _enc = _both(run)
    assert len(bh) == 32


def test_get_blob_from_chunks_matches():
    """The padded batch blob of the integration layer is byte-equal."""
    def run(_agg, _blob, _c, integ, _m, ci):
        infos = [_chunk_info(ci, 3, post="0x" + "ee" * 32), _chunk_info(ci, 4, prev="0x" + "ee" * 32)]
        return integ.get_blob_from_chunks(infos)

    assert len(_both(run)) > 1


def _header(agg, ci):
    infos = [_chunk_info(ci, 0)]
    blob = agg.get_blob_bytes(agg.BatchData.new(1, infos).get_batch_data_bytes(), compress=False)
    return agg.BatchHeader.construct_from_chunks(4, 1, 0, 0, b"\x00" * 32, 99, infos, blob)


def test_batch_circuit_mock_chaining():
    """The sponge BatchCircuit: equal digests and min_k, satisfied under
    both mock provers; a broken chain fails a copy constraint in both."""
    c0 = [1, 2, 534352, 10, 11, 20, 21, 30, 31, 40, 41]
    c1 = [1, 2, 534352, 20, 21, 25, 26, 30, 31, 40, 41]
    c1_bad = list(c1)
    c1_bad[3] = 999

    def run(agg, _blob, circuits, _i, mock, ci):
        header = _header(agg, ci)
        circ = circuits.BatchCircuit([(c0, b"\x01" * 100), (c1, b"\x02" * 100)], header)
        inst = circ.instance_for()
        mock.run(circ.min_k(), circ, inst).assert_satisfied()
        bad = circuits.BatchCircuit([(c0, b"\x01" * 100), (c1_bad, b"\x02" * 100)], header)
        kinds = sorted({f.kind for f in mock.run(bad.min_k(), bad, bad.instance_for()).verify()})
        return inst, circ.min_k(), kinds

    _inst, _k, kinds = _both(run)
    assert "copy" in kinds


def test_recursion_circuit_mock():
    def run(_agg, _blob, circuits, _i, mock, _ci):
        circ = circuits.RecursionCircuit([([9, 8], b"\xaa" * 64), ([7, 6], b"\xbb" * 64)], b"\x01" * 32, b"\x02" * 32)
        inst = circ.instance_for()
        mock.run(circ.min_k(), circ, inst).assert_satisfied()
        return inst, circ.min_k()

    _both(run)


def test_bundle_partitions_header_chaining():
    """10 batches partitioned into bundles with parent-hash chaining: the
    headers' hashes are equal in both packages, each bundle chains, a
    shuffled pair does not."""
    def run(agg, _blob, _c, _i, _m, ci):
        headers = []
        parent = b"\x00" * 32
        for i in range(10):
            info = ci.ChunkInfo(
                chain_id=534352,
                prev_state_root="0x" + f"{i:02x}" * 32,
                post_state_root="0x" + f"{i + 1:02x}" * 32,
                withdraw_root="0x" + "aa" * 32,
                data_hash="0x" + "bb" * 32,
                is_padding=False,
                tx_bytes=b"tx-%d" % i,
            )
            blob = agg.get_blob_bytes(agg.BatchData.new(1, [info]).get_batch_data_bytes())
            h = agg.BatchHeader.construct_from_chunks(4, i, 0, 0, parent, 100 + i, [info], blob)
            assert h.parent_batch_hash == parent
            headers.append(h)
            parent = h.batch_hash()
        for lo, hi in ((0, 1), (1, 3), (3, 6), (6, 10)):
            hs = headers[lo:hi]
            for a, b in zip(hs, hs[1:]):
                assert b.parent_batch_hash == a.batch_hash(), "bundle chain broken"
        assert headers[5].parent_batch_hash != headers[3].batch_hash()
        return [h.batch_hash() for h in headers]

    assert len(_both(run)) == 10
