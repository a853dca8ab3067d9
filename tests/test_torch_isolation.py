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
from scroll_prover_tpu_torch.ops.ntt_fast import FastDomain
from scroll_prover_tpu_torch.ops.ntt_tile import TiledDomain
from scroll_prover_tpu_torch.ops.poseidon_dev import PoseidonDev
from scroll_prover_tpu_torch.proof_system import kzg
from scroll_prover_tpu_torch.proof_system.plonk import prover as tprover

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
     "prove", "coset_cache_cap"],
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


@pytest.mark.parametrize("kernel", ["K6", "K7", "K8"])
def test_new_kernel_wrappers_reject_cpu_tensors(kernel):
    """K6-K8 wrappers launch on CUDA tensors or raise; the plain versions are
    reached only through the dispatchers, for CPU tensors."""
    x = torch.zeros((16, 16), dtype=torch.int32)
    tw = torch.zeros((16, 8), dtype=torch.int32)
    calls = {
        "K6": lambda: tmt._msm_buckets_lanes_k6(
            torch.zeros((16, 1, 1, 4), dtype=torch.int32), torch.zeros((16, 1, 1, 4), dtype=torch.int32),
            torch.zeros((64, 1, 1, 4), dtype=torch.int32), torch.zeros((64, 1, 1, 4), dtype=torch.int32)),
        "K7": lambda: tnf._butterfly_k7(x, tw, 0),
        "K8": lambda: tnf._butterfly4_k8(x, tw, 0),
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
from scroll_prover_tpu_torch.l2types import BlockTrace
from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block
from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit
from tests.torch_trace_cases import trace_dict
zktrie.native_available()
wb = chunk_trace_to_witness_block([BlockTrace.from_json(trace_dict())])
ScrollSuperCircuit.new_from_block(wb).min_k()
bad = [e for e in seen if e[1].startswith(jax_dir)]
print(len(seen), bad)
assert not bad, bad
"""


def test_port_reads_and_builds_nothing_of_the_jax_package():
    """Importing every module, building the native zktrie and making a
    witness open, spawn, create or rename nothing under scroll_prover_tpu/
    (audit hooks in a fresh interpreter)."""
    jax_dir = os.path.join(ROOT, "scroll_prover_tpu") + os.sep
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _AUDIT, jax_dir], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[0]) > 0
