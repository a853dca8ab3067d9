"""Pure-Python zstd frame decoder with a lookup-table-shaped step trace.

The stepping stone to IN-CIRCUIT blob decompression: the reference's BatchCircuit proves the blob
decompresses to the batch payload (scroll zstd fork + aggregator
decoder circuit, SURVEY §2.2 native component #4). This module decodes
the SAME frames — verified against the reference's released blob, whose
fork format is standard zstd minus the 4-byte magic (native/zstd_codec) —
entirely in Python, and EMITS EVERY DECODING DECISION as a structured
step row:

  ("lit",  dst, byte)               literal byte copy to output position
  ("match", dst, offset, length)    back-reference copy
  ("fse",  stream, state, symbol, nbits)  FSE state transition taken
  ("huff", stream, state?, symbol, nbits) huffman code consumed

Step rows of this shape are exactly what a circuit decoder consumes:
each kind becomes a lookup table (FSE decode tables, huffman decode
tables, copy rows into the output column), and the row sequence is the
witness trace. RFC 8878 is the format source of truth; only the features
the scroll fork/our encoder emit are supported (single-segment frames,
no dictionaries, no checksum verification beyond skipping).
"""
from __future__ import annotations

from dataclasses import dataclass, field


class ZstdFormatError(ValueError):
    pass


# --- bit readers -------------------------------------------------------------


class _ForwardBits:
    """LSB-first forward bit reader (huffman tree descriptions &c. use
    byte-level reads; FSE table descriptions use forward bit reads)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read(self, n: int) -> int:
        out = 0
        for i in range(n):
            byte = self.data[(self.pos + i) >> 3]
            out |= ((byte >> ((self.pos + i) & 7)) & 1) << i
        self.pos += n
        return out

    def bytes_consumed(self) -> int:
        return (self.pos + 7) >> 3


class _BackwardBits:
    """zstd bitstreams are written forward but READ BACKWARD from the
    last byte; the top set bit of the final byte is the end marker."""

    def __init__(self, data: bytes):
        if not data:
            raise ZstdFormatError("empty bitstream")
        last = data[-1]
        if last == 0:
            raise ZstdFormatError("corrupt bitstream (zero padding byte)")
        # bits available: everything below the marker bit
        self.data = data
        self.bits_left = 8 * len(data) - (8 - (last.bit_length() - 1))

    def read(self, n: int) -> int:
        """Read n bits (MSB-first within the stream's backward order)."""
        if n == 0:
            return 0
        if n > self.bits_left:
            # zstd allows reading past the start with zero bits for the
            # final state reloads
            pad = n - self.bits_left
            got = self._peek(self.bits_left) << pad if self.bits_left else 0
            self.bits_left = 0
            return got
        self.bits_left -= n
        return self._extract(self.bits_left, n)

    def _peek(self, n: int) -> int:
        return self._extract(self.bits_left - n, n) if n else 0

    def _extract(self, start: int, n: int) -> int:
        out = 0
        for i in range(n):
            b = start + n - 1 - i  # MSB first
            out = (out << 1) | ((self.data[b >> 3] >> (b & 7)) & 1)
        return out

    def finished(self) -> bool:
        return self.bits_left == 0


# --- FSE ---------------------------------------------------------------------


@dataclass
class FseTable:
    accuracy_log: int
    # decode table rows: state -> (symbol, nbits, base)
    symbols: list = field(default_factory=list)
    nbits: list = field(default_factory=list)
    base: list = field(default_factory=list)

    @classmethod
    def from_distribution(cls, norm: list[int], accuracy_log: int) -> "FseTable":
        """RFC 8878 §4.1.1 decoding table construction."""
        size = 1 << accuracy_log
        t = cls(accuracy_log, [0] * size, [0] * size, [0] * size)
        # -1 ("less than 1") probabilities get the high states
        high = size - 1
        counts = list(norm)
        for s, p in enumerate(counts):
            if p == -1:
                t.symbols[high] = s
                high -= 1
        pos = 0
        step = (size >> 1) + (size >> 3) + 3
        mask = size - 1
        for s, p in enumerate(counts):
            if p <= 0:
                continue
            for _ in range(p):
                t.symbols[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdFormatError("FSE table spread did not close")
        # per-state nbits/base: states of a symbol in order
        next_count = {}
        for s, p in enumerate(counts):
            next_count[s] = p if p > 0 else (1 if p == -1 else 0)
        seen = {}
        for state in range(size):
            s = t.symbols[state]
            i = seen.get(s, 0)
            seen[s] = i + 1
            total = next_count[s]
            # RFC: the i-th occurrence (in state order) gets:
            x = total + i
            hb = x.bit_length() - 1
            t.nbits[state] = accuracy_log - hb
            t.base[state] = (x << t.nbits[state]) - size
        return t


def _read_fse_distribution(data: bytes) -> tuple[list[int], int, int]:
    """RFC 8878 §4.1.1 FSE table description -> (norm, accuracy_log,
    bytes consumed). Port of the canonical FSE_readNCount control flow:
    the code width SHRINKS as the remaining probability mass drops, and
    small values ride a one-bit-short fast path."""
    br = _ForwardBits(data)
    accuracy_log = br.read(4) + 5
    if accuracy_log > 15:
        raise ZstdFormatError("accuracy log too large")
    table_size = 1 << accuracy_log
    remaining = table_size + 1
    threshold = table_size
    nbits = accuracy_log + 1
    norm: list[int] = []
    while remaining > 1:
        maxv = (2 * threshold - 1) - remaining
        low = br.read(nbits - 1)
        if low < maxv:
            count = low
        else:
            extra = br.read(1)
            count = low + (extra << (nbits - 1))
            if count >= threshold:
                count -= maxv
        count -= 1  # -1 encodes "less than 1" probability
        remaining -= -count if count < 0 else count
        norm.append(count)
        if count == 0:
            while True:
                rep = br.read(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
        while remaining > 1 and remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdFormatError("FSE distribution overshoot")
    return norm, accuracy_log, br.bytes_consumed()


# --- predefined tables (RFC 8878 §3.1.1.3.2.2) -------------------------------

_LL_DEFAULT = (
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = (
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = (
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, -1, -1, -1, -1, -1], 5)

_LL_CODE = [
    (0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (7, 0),
    (8, 0), (9, 0), (10, 0), (11, 0), (12, 0), (13, 0), (14, 0), (15, 0),
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16),
]
_ML_CODE = [
    (3, 0), (4, 0), (5, 0), (6, 0), (7, 0), (8, 0), (9, 0), (10, 0),
    (11, 0), (12, 0), (13, 0), (14, 0), (15, 0), (16, 0), (17, 0), (18, 0),
    (19, 0), (20, 0), (21, 0), (22, 0), (23, 0), (24, 0), (25, 0), (26, 0),
    (27, 0), (28, 0), (29, 0), (30, 0), (31, 0), (32, 0), (33, 0), (34, 0),
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16),
]


# --- huffman -----------------------------------------------------------------


@dataclass
class HuffTable:
    max_bits: int
    # decode rows: code-prefix state -> (symbol, nbits)
    symbols: list = field(default_factory=list)
    nbits: list = field(default_factory=list)

    @classmethod
    def from_weights(cls, weights: list[int]) -> "HuffTable":
        total = sum((1 << (w - 1)) for w in weights if w > 0)
        # the LAST symbol's weight is implied to complete the nearest power
        # of two above the sum, 2^max_bits: the table's depth (RFC 8878
        # §4.2.1.3, Max_Number_of_Bits). The JAX package takes 2^(max_bits+1)
        # for the table and 0 for `left` when the sum is a power of two, so
        # it refuses every tree
        max_bits = total.bit_length()
        left = (1 << max_bits) - total
        if left <= 0 or left & (left - 1):
            raise ZstdFormatError("huffman weights do not complete")
        last_w = left.bit_length()  # 2^(w-1) = left
        weights = weights + [last_w]
        nbits_per_sym = [
            (max_bits + 1 - w) if w > 0 else 0 for w in weights
        ]
        size = 1 << max_bits
        t = cls(max_bits, [0] * size, [0] * size)
        # rank symbols by weight ascending... canonical: lower weight
        # (longer codes) first at low code values
        code = 0
        for w in range(1, max_bits + 1):
            for s, sw in enumerate(weights):
                if sw != w:
                    continue
                nb = max_bits + 1 - w
                span = 1 << (max_bits - nb)
                for i in range(span):
                    t.symbols[code + i] = s
                    t.nbits[code + i] = nb
                code += span
        if code != size:
            raise ZstdFormatError("huffman table incomplete")
        return t


def _read_huffman(data: bytes, trace) -> tuple[HuffTable, int]:
    """Huffman tree description -> (table, bytes consumed)."""
    hdr = data[0]
    if hdr >= 128:
        # direct 4-bit weights for hdr-127 symbols
        n = hdr - 127
        nbytes = (n + 1) // 2
        weights = []
        for i in range(n):
            b = data[1 + (i >> 1)]
            weights.append((b >> 4) if i % 2 == 0 else (b & 0xF))
        return HuffTable.from_weights(weights), 1 + nbytes
    # FSE-compressed weights
    comp = data[1 : 1 + hdr]
    norm, alog, used = _read_fse_distribution(comp)
    table = FseTable.from_distribution(norm, alog)
    bits = _BackwardBits(comp[used:])
    # two interleaved states
    s1 = bits.read(alog)
    s2 = bits.read(alog)
    weights = []
    while True:
        weights.append(table.symbols[s1])
        trace.append(("fse", "hweights", s1, table.symbols[s1], table.nbits[s1]))
        if bits.finished() and table.nbits[s1] > 0:
            pass
        nb = table.nbits[s1]
        if bits.bits_left < nb:
            # flush: emit final state symbol of the OTHER stream and stop
            weights.append(table.symbols[s2])
            break
        s1 = table.base[s1] + bits.read(nb)
        s1, s2 = s2, s1
    return HuffTable.from_weights(weights), 1 + hdr


# --- main decoder ------------------------------------------------------------


@dataclass
class DecodeResult:
    data: bytes
    trace: list
    blocks: int


def decode_frame(data: bytes, trace_steps: bool = True) -> DecodeResult:
    """Decode one zstd frame (magic optional). Returns output + trace."""
    MAGIC = bytes.fromhex("28b52ffd")
    if data[:4] == MAGIC:
        data = data[4:]
    pos = 0
    fhd = data[pos]
    pos += 1
    single_segment = (fhd >> 5) & 1
    content_checksum = (fhd >> 2) & 1
    dict_flag = fhd & 3
    fcs_code = fhd >> 6
    if dict_flag:
        raise ZstdFormatError("dictionaries unsupported")
    if not single_segment:
        pos += 1  # window descriptor
    fcs_len = {0: (1 if single_segment else 0), 1: 2, 2: 4, 3: 8}[fcs_code]
    pos += fcs_len
    out = bytearray()
    trace: list = []
    offsets = [1, 4, 8]  # repeat-offset history
    prev_huff: HuffTable | None = None
    prev_tables = {}
    blocks = 0
    while True:
        bh = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        blocks += 1
        if btype == 0:  # raw
            for b in data[pos : pos + bsize]:
                if trace_steps:
                    trace.append(("lit", len(out), b))
                out.append(b)
            pos += bsize
        elif btype == 1:  # RLE
            b = data[pos]
            pos += 1
            for _ in range(bsize):
                if trace_steps:
                    trace.append(("lit", len(out), b))
                out.append(b)
        elif btype == 2:  # compressed
            block = data[pos : pos + bsize]
            pos += bsize
            prev_huff = _decode_block(
                block, out, trace if trace_steps else None, offsets,
                prev_huff, prev_tables,
            )
        else:
            raise ZstdFormatError("reserved block type")
        if last:
            break
    if content_checksum:
        pos += 4
    return DecodeResult(bytes(out), trace, blocks)


def _decode_block(block, out, trace, offsets, prev_huff, prev_tables):
    t = trace if trace is not None else []
    # --- literals section ---
    lh = block[0]
    lit_type = lh & 3
    size_format = (lh >> 2) & 3
    pos = 0
    if lit_type in (0, 1):  # raw / RLE literals
        if size_format in (0, 2):
            regen = lh >> 3
            pos = 1
        elif size_format == 1:
            regen = (lh >> 4) | (block[1] << 4)
            pos = 2
        else:
            regen = (lh >> 4) | (block[1] << 4) | (block[2] << 12)
            pos = 3
        if lit_type == 0:
            literals = block[pos : pos + regen]
            pos += regen
        else:
            literals = bytes([block[pos]]) * regen
            pos += 1
        huff = prev_huff
    else:  # compressed / treeless literals
        if size_format == 0:
            both = (int.from_bytes(block[0:3], "little")) >> 4
            regen = both & 0x3FF
            comp = both >> 10
            pos = 3
            streams = 1
        elif size_format == 1:
            both = (int.from_bytes(block[0:3], "little")) >> 4
            regen = both & 0x3FF
            comp = both >> 10
            pos = 3
            streams = 4
        elif size_format == 2:
            both = (int.from_bytes(block[0:4], "little")) >> 4
            regen = both & 0x3FFF
            comp = both >> 14
            pos = 4
            streams = 4
        else:
            both = (int.from_bytes(block[0:5], "little")) >> 4
            regen = both & 0x3FFFF
            comp = both >> 18
            pos = 5
            streams = 4
        section = block[pos : pos + comp]
        pos += comp
        spos = 0
        if lit_type == 2:
            huff, used = _read_huffman(section, t)
            spos = used
        else:
            huff = prev_huff
            if huff is None:
                raise ZstdFormatError("treeless literals without a tree")
        payload = section[spos:]
        literals = bytearray()
        if streams == 1:
            _huff_stream(payload, huff, regen, literals, t, 0)
        else:
            s1 = int.from_bytes(payload[0:2], "little")
            s2 = int.from_bytes(payload[2:4], "little")
            s3 = int.from_bytes(payload[4:6], "little")
            body = payload[6:]
            sizes = [s1, s2, s3, len(body) - s1 - s2 - s3]
            outs = [(regen + 3) // 4] * 3 + [regen - 3 * ((regen + 3) // 4)]
            off = 0
            for i in range(4):
                _huff_stream(
                    body[off : off + sizes[i]], huff, outs[i], literals, t, i
                )
                off += sizes[i]
        literals = bytes(literals)
    # --- sequences section ---
    body = block[pos:]
    if not body:
        nseq = 0
    else:
        b0 = body[0]
        if b0 < 128:
            nseq = b0
            body = body[1:]
        elif b0 < 255:
            nseq = ((b0 - 128) << 8) + body[1]
            body = body[2:]
        else:
            nseq = int.from_bytes(body[1:3], "little") + 0x7F00
            body = body[3:]
    if nseq == 0:
        for b in literals:
            if trace is not None:
                t.append(("lit", len(out), b))
            out.append(b)
        return huff
    modes = body[0]
    body = body[1:]
    tables = {}
    for name, shift, default, max_log in (
        ("ll", 6, _LL_DEFAULT, 9), ("of", 4, _OF_DEFAULT, 8),
        ("ml", 2, _ML_DEFAULT, 9),
    ):
        mode = (modes >> shift) & 3
        if mode == 0:
            tables[name] = FseTable.from_distribution(*default)
        elif mode == 1:  # RLE: single symbol, 0 bits
            sym = body[0]
            body = body[1:]
            tb = FseTable(0, [sym], [0], [0])
            tables[name] = tb
        elif mode == 2:
            norm, alog, used = _read_fse_distribution(body)
            if alog > max_log:
                raise ZstdFormatError("accuracy log over cap")
            tables[name] = FseTable.from_distribution(norm, alog)
            body = body[used:]
        else:
            tables[name] = prev_tables[name]
    prev_tables.update(tables)
    bits = _BackwardBits(body)
    ll_t, of_t, ml_t = tables["ll"], tables["of"], tables["ml"]
    ll_s = bits.read(ll_t.accuracy_log)
    of_s = bits.read(of_t.accuracy_log)
    ml_s = bits.read(ml_t.accuracy_log)
    lit_pos = 0
    for i in range(nseq):
        of_code = of_t.symbols[of_s]
        ml_code = ml_t.symbols[ml_s]
        ll_code = ll_t.symbols[ll_s]
        of_val = (1 << of_code) + bits.read(of_code)
        ml_base, ml_extra = _ML_CODE[ml_code]
        ml_val = ml_base + bits.read(ml_extra)
        ll_base, ll_extra = _LL_CODE[ll_code]
        ll_val = ll_base + bits.read(ll_extra)
        if trace is not None:
            t.append(("fse", "seq", i, (ll_code, of_code, ml_code),
                      (ll_val, of_val, ml_val)))
        # repeat-offset resolution (RFC 8878 §3.1.1.5)
        if of_val > 3:
            offset = of_val - 3
            offsets[2] = offsets[1]
            offsets[1] = offsets[0]
            offsets[0] = offset
        else:
            idx = of_val - 1
            if ll_val == 0:
                idx += 1
            if idx == 0:
                offset = offsets[0]
            else:
                offset = offsets[idx] if idx < 3 else offsets[0] - 1
                if idx == 1:
                    offsets[1] = offsets[0]
                elif idx >= 2:
                    offsets[2] = offsets[1]
                    offsets[1] = offsets[0]
                offsets[0] = offset
        # literal run
        for b in literals[lit_pos : lit_pos + ll_val]:
            if trace is not None:
                t.append(("lit", len(out), b))
            out.append(b)
        lit_pos += ll_val
        # match copy
        if trace is not None:
            t.append(("match", len(out), offset, ml_val))
        for _ in range(ml_val):
            out.append(out[len(out) - offset])
        # state updates (not after the final sequence)
        if i + 1 < nseq:
            ll_s = ll_t.base[ll_s] + bits.read(ll_t.nbits[ll_s])
            ml_s = ml_t.base[ml_s] + bits.read(ml_t.nbits[ml_s])
            of_s = of_t.base[of_s] + bits.read(of_t.nbits[of_s])
    # trailing literals
    for b in literals[lit_pos:]:
        if trace is not None:
            t.append(("lit", len(out), b))
        out.append(b)
    return huff


def _huff_stream(payload, huff, n_out, out, trace, stream_i):
    bits = _BackwardBits(payload)
    state = bits.read(huff.max_bits)
    for _ in range(n_out):
        sym = huff.symbols[state]
        nb = huff.nbits[state]
        out.append(sym)
        if trace is not None:
            trace.append(("huff", stream_i, state, sym, nb))
        low = state & ((1 << (huff.max_bits - nb)) - 1)
        state = (low << nb) | bits.read(nb)
