"""The four-step NTT with its rows split over the mesh's ranks.

An N = N1 * N2 point NTT runs as row NTTs, a twiddle product, one
all-to-all that moves the matrix from row-sharded to column-sharded (the
only exchange between ranks), and column NTTs. With w a primitive N-th
root of unity, n = n1 + N1 * n2 and k = k2 + N2 * k1:

    X[k2 + N2 * k1] = sum_{n1} w^(n1 * (k2 + N2 * k1))
                      * sum_{n2} (w^N1)^(n2 * k2) * x[n1 + N1 * n2]
                    = ColNTT_N1( w^(n1 * k2) * RowNTT_N2(x matrix) )

Each rank's row and column transforms are the tiled engine's batched
transforms (ops/ntt_tile.py `TiledDomain.ntt_batch`: K2 on the card), and
each rank builds its own rows of the twiddles w^(n1 * k2) on its device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..fields.limbs import FR_LIMB, N_LIMBS
from ..ops import field_ops as fo
from ..ops.ntt_tile import TiledDomain
from ..ops.poly import powers_outer_mont


class ShardedDomain:
    """Four-step plan for size 2^k split as N1 = 2^k1 rows x N2 columns;
    rows are split over the mesh's ranks, and the all-to-all hands each rank
    N2 / d columns between the two phases."""

    def __init__(self, domain, mesh, k1: int | None = None):
        self.domain = domain
        self.mesh = mesh
        d = mesh.size()
        self.n_dev = d
        k = domain.k
        if k1 is None:
            k1 = max((k + 1) // 2, (d - 1).bit_length())
        assert (1 << k1) % d == 0, "N1 must divide evenly across devices"
        self.k1, self.k2 = k1, k - k1
        self.n1, self.n2 = 1 << k1, 1 << (k - k1)
        self._tables: dict = {}

    def _device_tables(self, device):
        """(row domain, column domain, this rank's (N1/d, N2, 16) rows of
        w^(n1 * k2)) on `device`; a length-1 transform is None."""
        key = str(device)
        if key not in self._tables:
            p = self.domain.field.modulus
            n1, n2, d = self.n1, self.n2, self.n_dev
            rows = torch.arange(n1 // d, device=device) + self.mesh.get_local_rank() * (n1 // d)
            exps = (rows[:, None] * torch.arange(n2, device=device)[None, :]).reshape(-1)
            pows = powers_outer_mont(self.domain.field, self.domain.omega % p, n1 * n2, device=device)
            tw_mid = pows.index_select(0, exps).reshape(n1 // d, n2, N_LIMBS)
            self._tables[key] = (
                TiledDomain(self.k2, device) if self.k2 else None,
                TiledDomain(self.k1, device) if self.k1 else None,
                tw_mid,
            )
        return self._tables[key]

    def ntt(self, x):
        """x: (N, 16) Montgomery coefficients, the same on every rank ->
        this rank's (N1, N2/d, 16) columns of the evaluation matrix: element
        (k1, j) is X[r * N2/d + j + N2 * k1] on rank r."""
        n1, n2, d = self.n1, self.n2, self.n_dev
        row_dom, col_dom, tw_mid = self._device_tables(x.device)
        r = self.mesh.get_local_rank()
        mat = x.reshape(n2, n1, N_LIMBS).transpose(0, 1)  # (n1, n2, 16)
        a = mat[r * (n1 // d):(r + 1) * (n1 // d)].contiguous()
        if row_dom is not None:
            a = row_dom.ntt_batch(a)  # row NTTs, length n2
        a = fo.mont_mul(FR_LIMB, a, tw_mid)
        # row-sharded -> column-sharded: block j of every rank's rows goes to rank j
        send = a.reshape(n1 // d, d, n2 // d, N_LIMBS).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.mesh.get_group())
        a = recv.reshape(n1, n2 // d, N_LIMBS).transpose(0, 1).contiguous()  # (n2/d, n1, 16)
        if col_dom is not None:
            a = col_dom.ntt_batch(a)  # column NTTs, length n1
        return a.transpose(0, 1)  # (n1, n2/d, 16)

    def ntt_flat(self, x):
        """The whole (N, 16) evaluations in natural order, on every rank."""
        mine = self.ntt(x).contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.n_dev)]
        dist.all_gather(parts, mine, group=self.mesh.get_group())
        return torch.stack(parts, dim=1).reshape(self.n1 * self.n2, N_LIMBS)
