"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points never drift to the CPU on their own."""
import copy
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import scroll_prover_tpu_torch
from scroll_prover_tpu_torch.ops import msm_tile as tmt
from scroll_prover_tpu_torch.ops import ntt_fast as tnf
from scroll_prover_tpu_torch.ops import ntt_tile as tnt
from scroll_prover_tpu_torch.ops.ntt_fast import FastDomain
from scroll_prover_tpu_torch.ops.ntt_tile import TiledDomain
from scroll_prover_tpu_torch.ops.poseidon_dev import PoseidonDev
from scroll_prover_tpu_torch.proof_system import kzg
from scroll_prover_tpu_torch.proof_system.plonk import prover as tprover
from scroll_prover_tpu_torch.integration import prove_and_verify_bundle
from scroll_prover_tpu_torch.prover import BatchProver, BatchVerifier, BundleProvingTask
from scroll_prover_tpu_torch.bin import chain_prover

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import scroll_prover_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "scroll_prover_tpu" or m.startswith("scroll_prover_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    """In a fresh interpreter (this process already imported JAX through
    conftest.py): import every module of the port and chip_smoke."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25


def test_chip_smoke_refuses_without_cuda():
    """Without a card chip_smoke.py exits non-zero and prints no ok line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize(
    "entry",
    ["generate", "generate_fast", "load", "srs_from_numpy", "tiled_domain", "fast_domain", "poseidon_dev",
     "prove", "coset_cache_cap", "batch_prover", "batch_verifier", "prove_and_verify_bundle", "chain_prover"],
)
def test_entry_points_refuse_silent_cpu(entry, tmp_path, monkeypatch):
    """Called without device="cpu" on a machine with no card, an entry point
    raises instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    # a cache cap set by the caller must not skip the device check
    monkeypatch.setenv("SPT_COSET_CACHE_COLS", "3")
    calls = {
        "generate": lambda: kzg.SRS.generate(2),
        "generate_fast": lambda: kzg.SRS.generate_fast(2),
        "load": lambda: kzg.SRS.load(_saved(tmp_path)),
        "srs_from_numpy": lambda: kzg.srs_from_numpy(
            1, np.zeros((2, 2, 16), np.uint32), np.zeros((2, 2, 16), np.uint32), None, None
        ),
        "tiled_domain": lambda: TiledDomain(4),
        "fast_domain": lambda: FastDomain(4),
        "poseidon_dev": lambda: PoseidonDev(),
        # prove (whose quotient streams the cosets) runs on its SRS's device
        "prove": lambda: _prove_on_cuda_srs(),
        "coset_cache_cap": lambda: tprover._coset_cache_cap(1 << 20, 600, None),
        "batch_prover": lambda: BatchProver({}),
        "batch_verifier": lambda: BatchVerifier({}),
        "prove_and_verify_bundle": lambda: prove_and_verify_bundle({}, "", BundleProvingTask([])),
        "chain_prover": lambda: chain_prover.main([]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def _prove_on_cuda_srs():
    """prove() of a small circuit whose keys were made on the CPU, with an
    SRS that names the card."""
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
    from tests.test_torch_plonk import CIRCUITS, INSTANCE, K

    srs = kzg.SRS.generate(K, device="cpu")
    circ = CIRCUITS["bench"][1]()
    pk, _vk = keygen(srs, K, circ)
    on_card = copy.copy(srs)  # generate() caches srs: leave it as it is
    on_card.device = torch.device("cuda")
    tprover.prove(on_card, pk, circ, INSTANCE, seed=b"isolation")


def _saved(tmp_path):
    path = str(tmp_path / "srs2")
    kzg.SRS.generate(2, device="cpu").save(path)
    return path


def test_every_module_is_listed():
    """Every module of the package is importable here too (the tests import
    the port next to JAX)."""
    names = [m.name for m in pkgutil.walk_packages(scroll_prover_tpu_torch.__path__, "scroll_prover_tpu_torch.")]
    assert "scroll_prover_tpu_torch.proof_system.plonk.prover" in names
    assert "scroll_prover_tpu_torch.ops.cuda_lib" in names
    for mod in ("aggregator", "aggregator.constants", "aggregator.blob", "aggregator.batch_data",
                "aggregator.batch_header", "aggregator.zstd_decoder", "aggregator.circuits",
                "curves.bls12_381", "curves.bls12_381_pairing", "gadgets.blob_eval", "native.zstd_codec",
                "prover.aggregation_circuit", "prover.proofs", "prover.provers", "integration.prove",
                "evm.interpreter", "evm.verifier_contract", "evm.full_verifier", "evm.harness",
                "proof_system.plonk.checkpoint", "orchestration", "orchestration.settings",
                "orchestration.clients", "orchestration.builders", "orchestration.prove_utils",
                "bin.chain_prover", "bin.trace_prover"):
        assert f"scroll_prover_tpu_torch.{mod}" in names, mod


_EVM_SIDE = """
import sys
from scroll_prover_tpu_torch.evm import DEPLOYMENT_CODE_FILENAME, EVMVerifier, gen_verifier_bytecode
from scroll_prover_tpu_torch.evm.full_verifier import Gen, gen_full_verifier, proof_calldata
from scroll_prover_tpu_torch.integration import prove_and_verify_bundle
from scroll_prover_tpu_torch.prover import BatchProver, BatchVerifier, BundleProof
from scroll_prover_tpu_torch.prover.proofs import ProofPayload
from scroll_prover_tpu_torch.prover.provers import _bundle_expose, _bundle_links
p = ProofPayload(proof=bytes(range(64)), instances=[1, 2], protocol={}, vk_id="0x1")
b = BundleProof(layers=[p, p])
assert b.calldata() == (1).to_bytes(32, "big") + (2).to_bytes(32, "big") + p.proof
assert proof_calldata([1], p.proof)[32:64] == p.proof[:32][::-1]
assert _bundle_links(2) and _bundle_expose(2)
code, yul = Gen().finish()
assert yul.startswith('object "plonk_verifier"')
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "scroll_prover_tpu" or m.startswith("scroll_prover_tpu."))
print(bad)
assert not bad, bad
"""


def test_evm_and_bundle_code_imports_no_jax():
    """In a fresh interpreter: the EVM verifier, the bundle prover and
    verifier, BundleProof and prove_and_verify_bundle import and run their
    host code without jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _EVM_SIDE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "[]"


@pytest.mark.parametrize("kernel", ["K2", "K6", "K7", "K8", "K7 tile", "K8 tile", "K7 misaligned", "K8 misaligned"])
def test_new_kernel_wrappers_reject_cpu_tensors(kernel):
    """K2 and K6-K8 wrappers launch on CUDA tensors or raise; the plain
    versions are reached only through the dispatchers, for CPU tensors. So
    do K7/K8's checks of a tile size and of a plane that does not start on a
    16-byte boundary."""
    x = torch.zeros((16, 16), dtype=torch.int32)
    tw = torch.zeros((16, 16), dtype=torch.int32)
    shifted = torch.zeros((16 * 16 + 1,), dtype=torch.int32)[1:].view(16, 16)
    calls = {
        "K6": lambda: tmt._msm_buckets_lanes_k6(
            torch.zeros((16, 1, 1, 4), dtype=torch.int32), torch.zeros((16, 1, 1, 4), dtype=torch.int32),
            torch.zeros((64, 1, 1, 4), dtype=torch.int32), torch.zeros((64, 1, 1, 4), dtype=torch.int32)),
        "K2": lambda: tnt._ntt_pass_k2(
            torch.zeros((1, 16, 16), dtype=torch.int32), torch.zeros((4, 16, 8), dtype=torch.int32),
            4, 1, None, None, None, None, False, False),
        "K7": lambda: tnf._butterfly_k7(x, tw, 0),
        "K8": lambda: tnf._butterfly4_k8(x, tw, 0),
        "K7 tile": lambda: tnf._butterfly_k7(x, tw, 0, lg_tile=13),
        "K8 tile": lambda: tnf._butterfly4_k8(x, tw, 0, lg_tile=3),
        "K7 misaligned": lambda: tnf._butterfly_k7(shifted, tw, 0),
        "K8 misaligned": lambda: tnf._butterfly4_k8(shifted, tw, 0),
    }
    with pytest.raises(ValueError):
        calls[kernel]()


_AUDIT = """
import importlib, os, pkgutil, sys
jax_dir = os.path.realpath(sys.argv[1]) + os.sep
seen = []

def paths(event, args):
    if event == "subprocess.Popen":
        return [a for a in args[1] if isinstance(a, (str, bytes, os.PathLike))]
    return [a for a in args[:2] if isinstance(a, (str, bytes, os.PathLike))]

def hook(event, args):
    if event in ("open", "subprocess.Popen", "os.mkdir", "os.rename", "os.replace", "os.remove"):
        for p in paths(event, args):
            p = os.fsdecode(p)
            seen.append((event, os.path.realpath(p) if os.sep in p else p))

sys.addaudithook(hook)
import scroll_prover_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from scroll_prover_tpu_torch.trie import zktrie
from scroll_prover_tpu_torch.native import zstd_codec
from scroll_prover_tpu_torch.aggregator import BatchData, decode_blob_bytes, get_blob_bytes
from scroll_prover_tpu_torch.l2types import BlockTrace
from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block
from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit
from tests.torch_trace_cases import trace_dict
zktrie.native_available()
zstd_codec._BUILD_DIR = sys.argv[2]  # a fresh build, watched
zstd_codec.zstd_available()
raw = BatchData.new(0, []).get_batch_data_bytes() + b"x" * 100
assert decode_blob_bytes(get_blob_bytes(raw)) == raw
wb = chunk_trace_to_witness_block([BlockTrace.from_json(trace_dict())])
ScrollSuperCircuit.new_from_block(wb).min_k()
bad = [e for e in seen if e[1].startswith(jax_dir)]
print(len(seen), bad)
assert not bad, bad
"""


def test_port_reads_and_builds_nothing_of_the_jax_package(tmp_path):
    """Importing every module, building the native zktrie, building the
    native zstd codec afresh and enveloping a blob with it, and making a
    witness open, spawn, create or rename nothing under scroll_prover_tpu/
    (audit hooks in a fresh interpreter)."""
    jax_dir = os.path.join(ROOT, "scroll_prover_tpu") + os.sep
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _AUDIT, jax_dir, str(tmp_path / "zstd_build")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[0]) > 0
