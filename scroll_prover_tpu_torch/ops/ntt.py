"""Number-theoretic transform domain over BN254 Fr.

`EvaluationDomain(k, j)` mirrors the JAX package's (and halo2's)
EvaluationDomain: H of size 2^k for witness polynomials, the extended coset
zeta*H_ext of size 2^(k+j) for the quotient. Every transform runs on the
four-step tiled engine (ops/ntt_tile.py) on the device of its input — K1 and
K2 on the card, their plain versions on the CPU. The domain itself holds only
host integers; its device tables are built lazily per device.

Conventions: elements are (n, 16) int32 Montgomery limbs; natural order in
and out.
"""
from __future__ import annotations

from ..fields.bn254 import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY
from ..fields.limbs import FR_LIMB, N_LIMBS, LimbField
from . import field_ops as fo


class EvaluationDomain:
    def __init__(self, k: int, j: int = 0, field: LimbField = FR_LIMB):
        assert k + j <= FR_TWO_ADICITY
        self.field = field
        self.k = k
        self.j = j
        self.n = 1 << k
        p = field.modulus
        self.omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(self.n, -1, p)
        self._tables: dict = {}
        self.extended_k = k + j
        self.extended_n = 1 << self.extended_k
        self.extended_omega = pow(
            FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - self.extended_k), p
        )
        self.extended_omega_inv = pow(self.extended_omega, -1, p)
        self.extended_n_inv = pow(self.extended_n, -1, p)
        # coset generator (multiplicative generator of Fr*)
        self.g_coset = FR_GENERATOR
        self.g_coset_inv = pow(FR_GENERATOR, -1, p)

    # --- per-device tables ------------------------------------------------

    def _table(self, name: str, device):
        key = (name, str(device))
        t = self._tables.get(key)
        if t is None:
            from .ntt_tile import TiledDomain
            from .poly import powers_outer_mont

            if name == "tiled":
                t = TiledDomain(self.k, device)
            elif name == "tiled_ext":
                t = TiledDomain(self.extended_k, device)
            elif name == "coset_pow":
                t = powers_outer_mont(self.field, self.g_coset, self.extended_n, device=device)
            elif name == "coset_pow_inv":
                t = powers_outer_mont(self.field, self.g_coset_inv, self.extended_n, device=device)
            else:  # pragma: no cover
                raise KeyError(name)
            self._tables[key] = t
        return t

    # --- transforms -------------------------------------------------------

    def ntt(self, x):
        """Coefficients -> evaluations over H (natural order)."""
        assert x.shape == (self.n, N_LIMBS)
        return self._table("tiled", x.device).ntt(x)

    def intt(self, y):
        """Evaluations over H -> coefficients."""
        assert y.shape == (self.n, N_LIMBS)
        return self._table("tiled", y.device).intt(y)

    def ntt_extended(self, x):
        """Coefficients (padded to extended_n) -> evals over zeta*H_ext."""
        assert x.shape == (self.extended_n, N_LIMBS)
        x = fo.mont_mul_big(self.field, x, self._table("coset_pow", x.device))
        return self._table("tiled_ext", x.device).ntt(x)

    def prepare_intt_extended(self, device) -> None:
        """Build intt_extended's device tables now (they stay with the
        domain), so that memory sized before the first call also holds
        them."""
        self._table("tiled_ext", device)
        self._table("coset_pow_inv", device)

    def intt_extended(self, y):
        """Evals over zeta*H_ext -> coefficients."""
        assert y.shape == (self.extended_n, N_LIMBS)
        x = self._table("tiled_ext", y.device).intt(y)
        return fo.mont_mul_big(self.field, x, self._table("coset_pow_inv", y.device))

    # --- batched transforms: (C, n, 16) -----------------------------------

    def ntt_batch(self, x):
        assert x.dim() == 3 and x.shape[1] == self.n
        return self._table("tiled", x.device).ntt_batch(x)

    def intt_batch(self, y):
        assert y.dim() == 3 and y.shape[1] == self.n
        return self._table("tiled", y.device).intt_batch(y)

    def ntt_extended_batch(self, x):
        assert x.dim() == 3 and x.shape[1] == self.extended_n
        x = fo.mont_mul_big(self.field, x, self._table("coset_pow", x.device))
        return self._table("tiled_ext", x.device).ntt_batch(x)

    def intt_extended_batch(self, y):
        assert y.dim() == 3 and y.shape[1] == self.extended_n
        x = self._table("tiled_ext", y.device).intt_batch(y)
        return fo.mont_mul_big(self.field, x, self._table("coset_pow_inv", y.device))
