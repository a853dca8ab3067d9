"""In-circuit EIP-4844 blob consistency: barycentric evaluation gadget.

Constrains, over the BLS12-381 SCALAR field as a non-native modulus
(88-bit x 3 limbs, same CRT machinery as the BN254 gadgets):

    y * W  ==  (z^W - 1) * sum_i c_i * w_i / (z - w_i)      (mod BLS_r)

— the barycentric form of "y is the blob polynomial's evaluation at z"
that the reference BatchCircuit proves in-circuit (aggregator crate blob
consistency, SURVEY.md section 2.2). Per term the
quotient t_i = c_i*w_i/(z - w_i) is witnessed and pinned by
t_i * (z - w_i) == c_i * w_i; the division by W is cross-multiplied away.

The coefficients are witnessed as (hi, lo) 128-bit cell pairs; the caller
binds them (AggregationCircuit absorbs every pair into a dedicated
Poseidon sponge whose digest is exposed in the public input — the
verifier recomputes the digest from the actual blob bytes, so tampering
ANY blob byte breaks verification). z and y enter as existing context
cells, already checked against the BatchHeader's blob_data_proof.

`width` parameterizes the domain size: production uses the full 4096-coeff
blob; tests exercise the identical constraint system at width 64.
"""
from __future__ import annotations

from ..aggregator.blob import BLS_MODULUS
from .builder import Builder, Cell
from .nonnative import NnInt, NonNativeChip

M128 = (1 << 128) - 1
_PRIMITIVE_ROOT = 7  # same generator the host blob math derives from


def _brp_domain(width: int) -> list[int]:
    """Bit-reversal-permuted roots of unity of order `width` (the EIP-4844
    blob domain convention; equals aggregator.blob._roots_of_unity_brp at
    width 4096)."""
    bits = (width - 1).bit_length()
    w = pow(_PRIMITIVE_ROOT, (BLS_MODULUS - 1) // width, BLS_MODULUS)
    roots = []
    cur = 1
    for _ in range(width):
        roots.append(cur)
        cur = cur * w % BLS_MODULUS
    return [roots[int(bin(i)[2:].zfill(bits)[::-1], 2)] for i in range(width)]


class BlobEvalGadget:
    def __init__(self, b: Builder, width: int = 4096):
        assert width & (width - 1) == 0
        self.b = b
        self.width = width
        self.nn = NonNativeChip(b, BLS_MODULUS)
        self.domain = _brp_domain(width)

    def run(
        self,
        coeff_vals: list[int],
        z_hi: Cell,
        z_lo: Cell,
        y_hi: Cell,
        y_lo: Cell,
    ) -> list[tuple[Cell, Cell]]:
        """Witness the coefficients, constrain y == P(z); returns the
        (hi, lo) cell pairs for the caller's digest binding."""
        nn = self.nn
        b = self.b
        p = BLS_MODULUS
        assert len(coeff_vals) == self.width
        z = nn.load_u256(z_hi, z_lo)
        y = nn.load_u256(y_hi, y_lo)
        zv = z.value % p
        assert all(zv != w for w in self.domain), "z in the blob domain"

        cells: list[tuple[Cell, Cell]] = []
        total: NnInt | None = None
        for i, cv in enumerate(coeff_vals):
            cv = int(cv) % p
            hi = b.witness(cv >> 128)
            lo = b.witness(cv & M128)
            c = nn.load_u256(hi, lo)
            cells.append((hi, lo))
            w = self.domain[i]
            zw = nn.sub(z, nn.load_constant(w))
            cw = nn.mul(c, nn.load_constant(w))
            t_val = cw.value % p * pow((zv - w) % p, -1, p) % p
            t = nn.load_witness(t_val)
            nn.mul(t, zw, sub_out=cw)
            total = t if total is None else nn.add(total, t)
            if (i + 1) % 32 == 0:
                total = nn.reduce(total)
        total = nn.reduce(total)

        zn = z
        for _ in range(self.width.bit_length() - 1):
            zn = nn.mul(zn, zn)
        lhs = nn.mul(nn.sub(zn, nn.load_constant(1)), total)
        y_w = nn.reduce(nn.scale(y, self.width))
        one = nn.load_constant(1)
        nn.mul(lhs, one, sub_out=y_w)
        return cells
