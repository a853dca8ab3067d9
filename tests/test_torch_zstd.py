"""Port parity for the native zstd codec (native/zstd_codec.py, built by g++
from native/zstd_src/ into native/build/) and the step-traced decoder
(aggregator/zstd_decoder.py): the twin of tests/test_zstd_decoder.py and
tests/test_zstd_conformance.py, with their conditions: the codec must be
available, and the cases that read the reference's released blob need its
fixture. The compressed bytes and the decoder's step trace are equal to the
JAX package's; without the codec both packages fall back to the raw blob
envelope alike."""
import base64
import json
import os
import random

import pytest

import tests.torch_native_cases  # noqa: F401  (both packages' native libraries, built once under a lock)
from scroll_prover_tpu.aggregator import batch_data as jbd
from scroll_prover_tpu.aggregator.zstd_decoder import decode_frame as jdecode_frame
from scroll_prover_tpu.native import zstd_codec as jz
from scroll_prover_tpu_torch.aggregator import batch_data as tbd
from scroll_prover_tpu_torch.aggregator.zstd_decoder import decode_frame
from scroll_prover_tpu_torch.native import zstd_codec as tz
from scroll_prover_tpu_torch.native.zstd_codec import zstd_available, zstd_compress, zstd_decompress
from tests.test_zstd_decoder import FIXTURE

MAX_AGG_SNARKS = 45
needs_zstd = pytest.mark.skipif(not zstd_available(), reason="native zstd missing")
needs_fixture = pytest.mark.skipif(
    not (os.path.exists(FIXTURE) and zstd_available()), reason="fixture or native zstd missing"
)


def _replay(trace) -> bytes:
    out = bytearray()
    for step in trace:
        if step[0] == "lit":
            assert step[1] == len(out)
            out.append(step[2])
        elif step[0] == "match":
            _, dst, offset, length = step
            assert dst == len(out) and offset <= len(out)
            for _ in range(length):
                out.append(out[len(out) - offset])
    return bytes(out)


def _payloads():
    rng = random.Random(8)
    words = [b"the", b"proof", b"batch", b"chunk", b"blob", b"of", b"a", b"verifies"]
    return {
        "text": b"scroll-prover-tpu " * 500 + bytes(range(256)) * 3,  # FSE sequences, raw literals
        "random": bytes(rng.randrange(256) for _ in range(4096)),  # a raw block
        # Huffman-coded literals
        "batch": bytes(2 + 4 * MAX_AGG_SNARKS) + bytes(rng.randrange(4) for _ in range(3000)),
        "english": b" ".join(rng.choice(words) for _ in range(3000)),
    }


@needs_zstd
@pytest.mark.parametrize("name", ["text", "random"])
def test_roundtrip_own_encoder(name):
    """Compressed bytes equal to the JAX package's; the decoder rebuilds the
    payload, its trace replays to it from the lit/match rows alone, and the
    trace and block count equal the JAX decoder's."""
    payload = _payloads()[name]
    comp = zstd_compress(payload)
    assert comp == jz.zstd_compress(payload)
    r = decode_frame(comp)
    assert r.data == payload
    assert _replay(r.trace) == payload
    j = jdecode_frame(comp)
    assert (r.trace, r.blocks) == (j.trace, j.blocks)


@needs_zstd
@pytest.mark.parametrize("name", ["batch", "english"])
def test_huffman_literals_decoded(name):
    """Frames whose literals are Huffman-coded: the port's decoder rebuilds
    them byte for byte (libzstd's output) and its trace replays, with
    "huff" rows. The JAX package's decoder refuses every Huffman tree (its
    table is one bit too deep: "huffman table incomplete"); the port takes
    the depth RFC 8878 gives, so here it departs from the reference."""
    payload = _payloads()[name]
    comp = zstd_compress(payload)
    assert comp == jz.zstd_compress(payload)
    assert zstd_decompress(comp) == payload
    r = decode_frame(comp)
    assert r.data == payload
    assert _replay(r.trace) == payload
    assert "huff" in {s[0] for s in r.trace}
    with pytest.raises(ValueError, match="huffman table incomplete"):
        jdecode_frame(comp)


@needs_zstd
def test_magicless_roundtrip():
    payload = b"scroll-prover-tpu" * 1000 + bytes(range(256))
    comp = zstd_compress(payload)
    assert comp[:4] != bytes.fromhex("28b52ffd")  # scroll convention: magic stripped
    assert zstd_decompress(comp) == payload
    full = zstd_compress(payload, strip_magic=False)
    assert full == jz.zstd_compress(payload, strip_magic=False)
    assert zstd_decompress(full) == payload


def test_no_codec_falls_back_to_raw_envelope(monkeypatch, tmp_path):
    """A build that fails (no compiler here) leaves the codec unavailable,
    and both packages then envelope the batch raw, byte for byte alike."""
    monkeypatch.setattr(tz, "_lib", None)
    monkeypatch.setattr(tz, "_tried", False)
    monkeypatch.setattr(tz, "_lib_path", lambda: str(tmp_path / "libspt_zstd_missing.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not tz.zstd_available()
    assert not os.path.exists(tmp_path / "libspt_zstd_missing.so")
    monkeypatch.setattr(jz, "_load", lambda: None)
    raw = bytes(2 + 4 * MAX_AGG_SNARKS) + b"payload"
    blob = tbd.get_blob_bytes(raw)
    assert blob == jbd.get_blob_bytes(raw) == b"\x00" + raw
    assert tbd.decode_blob_bytes(blob) == raw
    with pytest.raises(RuntimeError, match="unavailable"):
        tz.zstd_compress(raw)


@needs_zstd
def test_library_built_from_the_ports_source():
    """The loaded library is the port's build of its own source."""
    assert tz._load() is not None
    path = tz._lib_path()
    assert os.path.dirname(path) == os.path.join(os.path.dirname(tz.__file__), "build")
    assert os.path.exists(path)


def _fixture_blob() -> bytes:
    with open(FIXTURE) as fh:
        return base64.b64decode(json.load(fh)["blob_bytes"])


@needs_fixture
def test_reference_blob_byte_exact():
    bb = _fixture_blob()
    assert bb[0] == 0x01
    want = zstd_decompress(bb[1:])
    r = decode_frame(bb[1:])
    assert r.data == want  # byte for byte against libzstd on the released blob
    assert r.blocks >= 1
    kinds = {s[0] for s in r.trace}
    assert "lit" in kinds and "match" in kinds and "fse" in kinds


@needs_fixture
def test_reference_blob_trace_replays():
    bb = _fixture_blob()
    r = decode_frame(bb[1:])
    assert _replay(r.trace) == zstd_decompress(bb[1:])
    try:
        jtrace = jdecode_frame(bb[1:]).trace
    except ValueError as e:  # the JAX decoder refuses Huffman trees (test_huffman_literals_decoded)
        assert "huffman table incomplete" in str(e)
    else:
        assert r.trace == jtrace


@needs_fixture
def test_reference_zstd_blob_decodes():
    batch = zstd_decompress(_fixture_blob()[1:])
    n = int.from_bytes(batch[:2], "big")
    assert 0 < n <= MAX_AGG_SNARKS
    sizes = [int.from_bytes(batch[2 + 4 * i: 6 + 4 * i], "big") for i in range(MAX_AGG_SNARKS)]
    assert all(s == 0 for s in sizes[n:])  # padding chunks are empty
    assert 2 + 4 * MAX_AGG_SNARKS + sum(sizes) == len(batch)


@needs_fixture
def test_reference_blob_via_decode_blob_bytes():
    batch = tbd.decode_blob_bytes(_fixture_blob())
    assert int.from_bytes(batch[:2], "big") > 0
    assert batch == jbd.decode_blob_bytes(_fixture_blob())
