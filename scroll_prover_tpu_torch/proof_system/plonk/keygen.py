"""Keygen: proving key / verifying key construction.

vk = domain + commitments to fixed columns and permutation sigma polys +
constraint-system shape; pk = vk + coefficient forms of fixed/sigma polys +
Lagrange-indicator polys, on the SRS's device. Sigma starts as the identity
permutation over the (perm column x row) grid; each copy constraint splices
two cycles; sigma values are coset labels delta^j * omega^i, computed on the
device as a gather plus one Montgomery product.

`VerifyingKey.to_bytes` is byte-identical to the JAX package's: its pickled
constraint-system shape names the JAX package's module paths for the
expression and column classes (`_JaxNamesPickler`), and `from_bytes` maps them
back to this package's classes.
"""
from __future__ import annotations

import io
import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch

from ...fields.bn254 import FR_GENERATOR, FR_MOD, FR_TWO_ADICITY
from ...fields.limbs import FR_LIMB, ints_to_limbs, limbs_to_torch, objcol_to_packed, packed_to_torch
from ...hashes.keccak import keccak256
from ...ops import field_ops as fo
from ...ops import poly as poly_ops
from ...ops.ntt import EvaluationDomain
from ..kzg import SRS, commit_group, kzg_commit_batch
from .cs import Circuit, ConstraintSystem, assign_cached, packed_column

# coset shift: DELTA generates distinct cosets of the 2^k subgroup H
DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, FR_MOD)

_PKG = __name__.split(".")[0]  # this package's top-level name
_JAX_PKG = "scroll_prover_tpu"


def encode_column(col, device) -> torch.Tensor:
    """Assignment column (ints, object array, or packed (n, 8) words) ->
    (n, 16) Montgomery limbs on `device`: host packed standard-form words,
    split into limbs on the device, then one to_mont product there."""
    packed = col if isinstance(col, np.ndarray) and col.dtype == np.uint32 else objcol_to_packed(col)
    return fo.to_mont(FR_LIMB, packed_to_torch(packed, device))


def _pickle_shape(shape: dict) -> bytes:
    buf = io.BytesIO()
    _JaxNamesPickler(buf, pickle.DEFAULT_PROTOCOL).dump(shape)
    return buf.getvalue()


_JAX_NAMES: dict[str, str] = {}


class _JaxNamesPickler(pickle._Pickler):
    """Pure-Python pickler whose globals from this package are written under
    the JAX package's names (same opcodes as the C pickler otherwise)."""

    def save_global(self, obj, name=None):
        mod = getattr(obj, "__module__", "") or ""
        if mod == _PKG or mod.startswith(_PKG + "."):
            if self.proto < 4:  # pragma: no cover
                raise pickle.PicklingError("vk pickles use protocol >= 4")
            # one string object per module, so the memo dedupes it as the
            # C pickler dedupes the interned __module__ string
            self.save(_JAX_NAMES.setdefault(mod, _JAX_PKG + mod[len(_PKG):]))
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _JAX_PKG or module.startswith(_JAX_PKG + "."):
            module = _PKG + module[len(_JAX_PKG):]
        return super().find_class(module, name)


@dataclass
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    fixed_commitments: list
    sigma_commitments: list
    domain: EvaluationDomain = field(repr=False)

    def transcript_repr(self) -> int:
        """Digest absorbed into every transcript (binds proof to circuit)."""
        h = bytearray()
        h += self.k.to_bytes(4, "big")
        for c in self.fixed_commitments + self.sigma_commitments:
            h += b"\x00" * 64 if c is None else (
                c[0].to_bytes(32, "little") + c[1].to_bytes(32, "little")
            )
        h += len(self.cs.gates).to_bytes(4, "big")
        return int.from_bytes(keccak256(bytes(h)), "big") % FR_MOD

    def to_bytes(self) -> bytes:
        """u32-be k, the commitments, then the constraint-system shape."""
        head = bytearray(b"SPTVK1")
        head += self.k.to_bytes(4, "big")
        head += len(self.fixed_commitments).to_bytes(4, "big")
        head += len(self.sigma_commitments).to_bytes(4, "big")
        for c in self.fixed_commitments + self.sigma_commitments:
            head += b"\x00" * 64 if c is None else (
                c[0].to_bytes(32, "little") + c[1].to_bytes(32, "little")
            )
        blob = _pickle_shape(
            {"gates": self.cs.gates, "lookups": self.cs.lookups,
             "perm_columns": self.cs.perm_columns,
             "num_fixed": self.cs.num_fixed, "num_advice": self.cs.num_advice,
             "num_instance": self.cs.num_instance,
             "num_challenges": self.cs.num_challenges}
        )
        return bytes(head) + len(blob).to_bytes(8, "big") + blob

    @classmethod
    def from_bytes(cls, data: bytes) -> "VerifyingKey":
        assert data[:6] == b"SPTVK1", "bad vk magic"
        k = int.from_bytes(data[6:10], "big")
        nf = int.from_bytes(data[10:14], "big")
        ns = int.from_bytes(data[14:18], "big")
        off = 18
        coms = []
        for _ in range(nf + ns):
            x = int.from_bytes(data[off : off + 32], "little")
            y = int.from_bytes(data[off + 32 : off + 64], "little")
            coms.append(None if x == y == 0 else (x, y))
            off += 64
        blen = int.from_bytes(data[off : off + 8], "big")
        shape = _PortUnpickler(io.BytesIO(data[off + 8 : off + 8 + blen])).load()
        cs = ConstraintSystem()
        cs.gates = shape["gates"]
        cs.lookups = shape["lookups"]
        cs.perm_columns = shape["perm_columns"]
        cs.num_fixed = shape["num_fixed"]
        cs.num_advice = shape["num_advice"]
        cs.num_instance = shape["num_instance"]
        cs.num_challenges = shape["num_challenges"]
        dom = EvaluationDomain(k, _extended_j(cs))
        return cls(k, cs, coms[:nf], coms[nf:], dom)


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_polys: list          # device (n, 16) Montgomery coeff forms (None
                               # after a lowmem keygen: built by the prove)
    fixed_values: list         # host (n, 8) packed standard-form words
    sigma_polys: list
    sigma_values: "_SigmaValues"
    l0: torch.Tensor = None
    l_last: torch.Tensor = None

    def sigma_col_mont(self, jj: int) -> torch.Tensor:
        """(n, 16) Montgomery device values of sigma column jj."""
        return self.sigma_values.col_mont(jj)


class _SigmaValues:
    """sigma[j][i] = delta^cj * omega^ci with (cj, ci) = divmod(nxt[j*n+i], n),
    computed on the device as a gather plus one Montgomery product."""

    def __init__(self, nxt: np.ndarray, m: int, n: int, omega: int, device):
        self.nxt = nxt
        self.m = m
        self.n = n
        self.device = device
        om_m = limbs_to_torch(ints_to_limbs([omega * (1 << 256) % FR_MOD])[0], device)
        self._om_pows = poly_ops.powers_mont(FR_LIMB, om_m, n)
        delta_pows = [pow(DELTA, j, FR_MOD) * (1 << 256) % FR_MOD for j in range(m)]
        self._delta_pows = limbs_to_torch(ints_to_limbs(delta_pows), device) if m else None

    def col_mont(self, jj: int) -> torch.Tensor:
        idx = torch.from_numpy(self.nxt[jj * self.n : (jj + 1) * self.n]).to(self.device)
        return fo.mont_mul(
            FR_LIMB,
            self._om_pows.index_select(0, idx % self.n),
            self._delta_pows.index_select(0, idx // self.n),
        )

    def __len__(self):
        return self.m


def keygen(srs: SRS, k: int, circuit: Circuit, instance=None, ckpt=None):
    """Returns (pk, vk), on the SRS's device. Fixed columns come from an
    assignment with a zero instance (fixed content must not depend on the
    witness).

    With SPT_LOWMEM=1 the fixed and sigma columns are committed from their
    values (over the Lagrange basis when the SRS has the domain's size: the
    same points as the coefficient forms' commits) one commit group at a
    time, and their coefficient forms are left to the first prove, which
    builds them at each use; `ckpt` (a checkpoint.ProveCheckpoint) then
    memoizes the two commit lists ("kg_fixed", "kg_sigma") across restarts.
    The vk is the same either way."""
    device = srs.device
    cs = ConstraintSystem()
    circuit.configure(cs)
    n = 1 << k
    dom = EvaluationDomain(k, _extended_j(cs))
    inst = np.empty((cs.num_instance, n), dtype=object)
    inst[:] = 0
    tables = assign_cached(circuit, cs, n, inst)
    # fixed values at rest on the host as packed standard-form words
    fixed_vals = [packed_column(tables["fixed"][i]) for i in range(cs.num_fixed)]
    tables = None

    sigma_vals = _SigmaValues(_build_next(cs, n), len(cs.perm_columns), n, dom.omega, device)
    if os.environ.get("SPT_LOWMEM") == "1":
        from .prover import _commit_values

        def commit_groups(count, column):
            out = []
            g = commit_group(n)
            for i in range(0, count, g):
                out += _commit_values(srs, dom, [column(j) for j in range(i, min(i + g, count))])
            return out

        def fixed_commits():
            return commit_groups(len(fixed_vals), lambda j: encode_column(fixed_vals[j], device))

        def sigma_commits():
            return commit_groups(len(sigma_vals), sigma_vals.col_mont)

        fixed_coms = fixed_commits() if ckpt is None else ckpt.points("kg_fixed", fixed_commits)
        sigma_coms = sigma_commits() if ckpt is None else ckpt.points("kg_sigma", sigma_commits)
        fixed_polys = sigma_polys = None
    else:
        fixed_polys = [dom.intt(encode_column(col, device)) for col in fixed_vals]
        sigma_polys = [dom.intt(sigma_vals.col_mont(j)) for j in range(len(sigma_vals))]
        fixed_coms = kzg_commit_batch(srs, fixed_polys)
        sigma_coms = kzg_commit_batch(srs, sigma_polys)

    usable = cs.usable_rows(n)
    l0_vals = np.zeros(n, dtype=np.int64)
    l0_vals[0] = 1
    l_last_vals = np.zeros(n, dtype=np.int64)
    l_last_vals[usable - 1] = 1

    vk = VerifyingKey(k, cs, fixed_coms, sigma_coms, dom)
    pk = ProvingKey(
        vk,
        fixed_polys,
        fixed_vals,
        sigma_polys,
        sigma_vals,
        l0=dom.intt(encode_column(l0_vals, device)),
        l_last=dom.intt(encode_column(l_last_vals, device)),
    )
    return pk, vk


def _build_next(cs: ConstraintSystem, n: int) -> np.ndarray:
    # columns by (kind, index) and the array through a memoryview: a layer
    # circuit splices millions of copies, one Python step each
    cols = {(c.kind, c.index): j * n for j, c in enumerate(cs.perm_columns)}
    m = len(cs.perm_columns)
    nxt = np.arange(m * n, dtype=np.int64)
    mv = memoryview(nxt)
    for (ca, ra), (cb, rb) in cs.copies:
        a = cols[ca.kind, ca.index] + ra
        b = cols[cb.kind, cb.index] + rb
        mv[a], mv[b] = mv[b], mv[a]
    return nxt


def _extended_j(cs: ConstraintSystem) -> int:
    d = max(cs.max_gate_degree(), 5)  # the permutation argument reaches degree 5
    return max((d - 1).bit_length(), 1)
