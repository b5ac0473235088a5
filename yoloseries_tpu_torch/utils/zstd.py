"""Zstandard frame decoder (RFC 8878) in numpy and plain Python.

Reads what tensorstore writes into an Orbax checkpoint (``utils/orbax.py``)
without the ``zstandard`` package: frames with or without the content size,
window descriptor or single-segment flag, with an optional XXH64 content
checksum (verified when the flag is set); raw, RLE and compressed blocks;
raw, RLE, Huffman (1 or 4 streams) and treeless literals; sequences in
predefined, RLE, FSE-compressed and repeat modes, with the repeat offsets
carried across blocks. Dictionaries are not supported.

On weight data nearly every byte is a Huffman-coded literal, so that path
is vectorized: for every bit position of a stream the (symbol, length) of
the code that starts there is looked up at once from the <= 11-bit table,
which gives each position's successor; the chain of positions from the
stream's end is then unrolled by pointer doubling. The FSE-coded sequences,
few on such data, are decoded in plain Python.

    from yoloseries_tpu_torch.utils.zstd import decompress
    raw = decompress(frame_bytes)
"""

from __future__ import annotations

import numpy as np

__all__ = ["ZstdError", "decompress", "xxh64"]

_MAGIC = 0xFD2FB528
_MAX_BLOCK = 1 << 17


class ZstdError(ValueError):
    """Malformed or unsupported zstd data."""


# --------------------------------------------------------------- XXH64

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum is its low 32 bits)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = np.frombuffer(data, "<u8", count=n // 32 * 4).tolist()
        for i in range(0, len(lanes), 4):
            v = [_round(v[j], lanes[i + j]) for j in range(4)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        p = n // 32 * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[p:p + 8], "little")), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1 & _M64), 23) * _P2
             + _P3) & _M64
        p += 4
    for b in data[p:]:
        h = (_rotl(h ^ (b * _P5 & _M64), 11) * _P1) & _M64
    h = ((h ^ (h >> 33)) * _P2) & _M64
    h = ((h ^ (h >> 29)) * _P3) & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------------ bit input

class _Backward:
    """A backward bitstream: read from the last byte's highest set bit (the
    end mark) down to bit 0; the first bit read is the value's MSB. Reading
    past bit 0 gives zeros and leaves ``pos`` negative."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream without an end mark")
        self.data = data
        self.pos = 8 * len(data) - 9 + data[-1].bit_length()

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        lo = self.pos
        if lo >= 0:
            v = int.from_bytes(self.data[lo >> 3:(lo + n + 7) >> 3], "little")
            return (v >> (lo & 7)) & ((1 << n) - 1)
        hi = lo + n
        if hi <= 0:
            return 0
        v = int.from_bytes(self.data[:(hi + 7) >> 3], "little") & ((1 << hi) - 1)
        return v << -lo


# ------------------------------------------------------------------ FSE

def _read_ncount(data: bytes, max_log: int, max_symbol: int):
    """An FSE table description -> (accuracy log, normalized counts, bytes
    used)."""
    x = int.from_bytes(data[:512], "little")
    log = (x & 0xF) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} > {max_log}")
    bit = 4
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts = []
    while remaining > 1:
        if counts and counts[-1] == 0:  # a zero is followed by 2-bit repeat flags
            while True:
                r = (x >> bit) & 3
                bit += 2
                counts.extend([0] * r)
                if r != 3:
                    break
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description: too many symbols")
        big = (2 * threshold - 1) - remaining
        low = (x >> bit) & (threshold - 1)
        if low < big:
            c = low
            bit += nbits - 1
        else:
            c = (x >> bit) & (2 * threshold - 1)
            if c >= threshold:
                c -= big
            bit += nbits
        c -= 1  # -1: "less than 1", one cell at the table's top
        remaining -= abs(c)
        counts.append(c)
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    used = (bit + 7) >> 3
    if remaining != 1 or len(counts) > max_symbol + 1 or used > len(data):
        raise ZstdError("bad FSE table description")
    return log, counts, used


def _fse_table(log: int, counts) -> tuple:
    """Decoding table of an FSE distribution: per state its symbol, the
    bits to read and the base of the next state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(c):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        state = nxt[sym[u]]
        nxt[sym[u]] += 1
        nb[u] = log - (state.bit_length() - 1)
        base[u] = (state << nb[u]) - size
    return log, sym, nb, base


def _rle_table(symbol: int) -> tuple:
    return 0, [symbol], [0], [0]


# RFC 8878 3.1.1.3.2.2: predefined distributions
_LL_DEFAULT = _fse_table(6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2,
                             2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
_ML_DEFAULT = _fse_table(6, [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, -1, -1, -1, -1, -1, -1, -1])
_OF_DEFAULT = _fse_table(5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, -1, -1, -1, -1, -1])

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# (default table, accuracy-log limit, largest symbol) of LL, OF, ML
_SEQ_KINDS = ((_LL_DEFAULT, 9, 35), (_OF_DEFAULT, 8, 31), (_ML_DEFAULT, 9, 52))


# -------------------------------------------------------------- Huffman

def _huffman_weights(data: bytes):
    """Huffman tree description -> (weights of all but the last symbol,
    bytes used)."""
    head = data[0]
    if head >= 128:  # direct: 4-bit weights
        n = head - 127
        used = 1 + (n + 1) // 2
        if used > len(data):
            raise ZstdError("truncated Huffman weights")
        w = []
        for b in data[1:used]:
            w += [b >> 4, b & 15]
        return w[:n], used
    used = 1 + head
    if used > len(data):
        raise ZstdError("truncated Huffman weights")
    body = data[1:used]
    log, counts, n = _read_ncount(body, 6, 255)
    _, sym, nb, base = _fse_table(log, counts)
    br = _Backward(body[n:])
    s1, s2 = br.read(log), br.read(log)
    w = []
    while len(w) < 255:  # two interleaved states until the stream runs out
        w.append(sym[s1])
        s1 = base[s1] + br.read(nb[s1])
        if br.pos < 0:
            w.append(sym[s2])
            break
        w.append(sym[s2])
        s2 = base[s2] + br.read(nb[s2])
        if br.pos < 0:
            w.append(sym[s1])
            break
    else:
        raise ZstdError("too many Huffman weights")
    return w, used


def _huffman_table(weights) -> tuple:
    """Weights -> (symbol, code length) per ``max_bits``-bit prefix."""
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight > 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise ZstdError("bad Huffman weights")
    weights = list(weights) + [rest.bit_length()]
    sym = np.empty(1 << max_bits, np.uint8)
    nb = np.empty(1 << max_bits, np.int32)
    pos = 0
    for w in range(1, max_bits + 1):  # lowest weight (longest code) first
        for s, ws in enumerate(weights):
            if ws == w:
                span = 1 << (w - 1)
                sym[pos:pos + span] = s
                nb[pos:pos + span] = max_bits + 1 - w
                pos += span
    return sym, nb, max_bits


def _chain(nxt: np.ndarray, start: int, n: int) -> np.ndarray:
    """[start, nxt[start], nxt[nxt[start]], ...] (n entries), by pointer
    doubling: jump tables of 2**k steps until at most ~2048 coarse steps
    are left, a Python walk at that stride, then each finer stride
    interleaved in."""
    jumps = [nxt]
    while n >> len(jumps) > 2048:
        j = jumps[-1]
        jumps.append(j[j])
    stride = 1 << (len(jumps) - 1)
    coarse, p = jumps[-1], start
    cur = np.empty(-(-n // stride), np.int32)
    for i in range(len(cur)):
        cur[i] = p
        p = coarse[p]
    for j in reversed(jumps[:-1]):
        stride >>= 1
        both = np.empty(2 * len(cur), np.int32)
        both[0::2] = cur
        both[1::2] = j[cur]
        cur = both[:-(-n // stride)]
    return cur


def _huffman_stream(stream: bytes, n: int, table) -> np.ndarray:
    """Decode ``n`` literals from one backward Huffman stream."""
    sym, nb, max_bits = table
    if n == 0:
        return np.empty(0, np.uint8)
    m = len(stream)
    if m == 0 or stream[-1] == 0:
        raise ZstdError("Huffman stream without an end mark")
    pad = 16  # zero bits below the stream, so every window is in range
    buf = np.zeros(m + 5, np.uint8)
    buf[2:2 + m] = np.frombuffer(stream, np.uint8)
    word = buf[:-3].astype(np.uint32)
    word |= buf[1:-2].astype(np.uint32) << 8
    word |= buf[2:-1].astype(np.uint32) << 16
    word |= buf[3:].astype(np.uint32) << 24
    # the code at remaining-bits position q is the max_bits-bit window that
    # ends at q; index positions by the window's start s = q - max_bits
    start = 8 * m - 9 + stream[-1].bit_length() + pad - max_bits
    windows = ((word[:, None] >> np.arange(8, dtype=np.uint32)) & ((1 << max_bits) - 1))
    windows = windows.ravel()[:start + 1]
    nxt = np.arange(start + 1, dtype=np.int32)
    nxt -= nb[windows]
    np.maximum(nxt, 0, out=nxt)
    pos = _chain(nxt, start, n)
    if int(nxt[pos[-1]]) != pad - max_bits:
        raise ZstdError("Huffman stream not consumed exactly")
    return sym[windows[pos]]


# --------------------------------------------------------------- blocks

class _FrameState:
    """What one block leaves to the next in a frame."""

    def __init__(self):
        self.huffman = None
        self.seq_tables = [None, None, None]
        self.reps = [1, 4, 8]


def _literals(blk: bytes, pos: int, st: _FrameState):
    b0 = blk[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw or RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (blk[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (blk[pos + 1] << 4) + (blk[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + size > len(blk):
                raise ZstdError("truncated raw literals")
            return blk[pos:pos + size], pos + size
        return bytes([blk[pos]]) * size, pos + 1
    hdr = 3 if fmt < 2 else fmt + 2
    c = int.from_bytes(blk[pos:pos + hdr], "little")
    bits = (10, 10, 14, 18)[fmt]
    regen = (c >> 4) & ((1 << bits) - 1)
    comp = (c >> (4 + bits)) & ((1 << bits) - 1)
    pos += hdr
    data = blk[pos:pos + comp]
    if len(data) != comp:
        raise ZstdError("truncated Huffman literals")
    if kind == 2:
        weights, used = _huffman_weights(data)
        st.huffman = _huffman_table(weights)
        data = data[used:]
    elif st.huffman is None:
        raise ZstdError("treeless literals without a previous table")
    if fmt == 0:
        lit = _huffman_stream(data, regen, st.huffman)
    else:
        sizes = [int.from_bytes(data[i:i + 2], "little") for i in (0, 2, 4)]
        sizes.append(len(data) - 6 - sum(sizes))
        seg = (regen + 3) // 4
        if sizes[3] < 0 or 3 * seg > regen:
            raise ZstdError("bad 4-stream literals")
        outs, at = [], 6
        for i, s in enumerate(sizes):
            outs.append(_huffman_stream(data[at:at + s], seg if i < 3 else regen - 3 * seg,
                                        st.huffman))
            at += s
        lit = np.concatenate(outs)
    return lit.tobytes(), pos + comp


def _sequences(blk: bytes, pos: int, lit: bytes, out: bytearray, st: _FrameState):
    """Decode the sequences section and execute it onto ``out``."""
    b0 = blk[pos]
    if b0 == 0:
        out += lit
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + blk[pos + 1], pos + 2
    else:
        nseq, pos = blk[pos + 1] + (blk[pos + 2] << 8) + 0x7F00, pos + 3
    modes = blk[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved sequence mode bits set")
    for i, shift in enumerate((6, 4, 2)):  # LL, OF, ML
        mode = (modes >> shift) & 3
        default, max_log, max_symbol = _SEQ_KINDS[i]
        if mode == 0:
            st.seq_tables[i] = default
        elif mode == 1:
            st.seq_tables[i] = _rle_table(blk[pos])
            pos += 1
        elif mode == 2:
            log, counts, used = _read_ncount(blk[pos:], max_log, max_symbol)
            st.seq_tables[i] = _fse_table(log, counts)
            pos += used
        elif st.seq_tables[i] is None:
            raise ZstdError("repeat mode without a previous table")
    (ll_log, ll_sym, ll_nb, ll_base), (of_log, of_sym, of_nb, of_base), \
        (ml_log, ml_sym, ml_nb, ml_base) = st.seq_tables
    br = _Backward(blk[pos:])
    read = br.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    r0, r1, r2 = st.reps
    at = 0
    for i in range(nseq):
        ofc = of_sym[of_s]
        ofv = (1 << ofc) + read(ofc)
        mlc, llc = ml_sym[ml_s], ll_sym[ll_s]
        ml = _ML_BASE[mlc] + read(_ML_BITS[mlc])
        ll = _LL_BASE[llc] + read(_LL_BITS[llc])
        if ofv > 3:
            off = ofv - 3
            r0, r1, r2 = off, r0, r1
        else:
            idx = ofv if ll == 0 else ofv - 1
            if idx == 0:
                off = r0
            elif idx == 1:
                off = r1
                r0, r1 = r1, r0
            elif idx == 2:
                off = r2
                r0, r1, r2 = r2, r0, r1
            else:
                off = r0 - 1
                if off == 0:
                    raise ZstdError("zero offset")
                r0, r1, r2 = off, r0, r1
        if ll:
            out += lit[at:at + ll]
            at += ll
            if at > len(lit):
                raise ZstdError("literal length past the literals")
        start = len(out) - off
        if start < 0:
            raise ZstdError("offset before the frame's start")
        if ml <= off:
            out += out[start:start + ml]
        else:
            pat = bytes(out[start:])
            out += (pat * (ml // off + 1))[:ml]
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if br.pos != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    st.reps = [r0, r1, r2]
    out += lit[at:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode one frame at ``data[pos:]`` onto ``out``; returns the end."""
    fhd = data[pos + 4]
    pos += 5
    if fhd & 8:
        raise ZstdError("reserved frame header bit set")
    single, has_checksum = (fhd >> 5) & 1, (fhd >> 2) & 1
    if not single:
        pos += 1  # window descriptor: the whole frame stays in memory
    did_size = (0, 1, 2, 4)[fhd & 3]
    if int.from_bytes(data[pos:pos + did_size], "little"):
        raise ZstdError("zstd dictionaries are not supported")
    pos += did_size
    fcs_size = ((1 if single else 0), 2, 4, 8)[fhd >> 6]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little")
        content_size += 256 if fcs_size == 2 else 0
        pos += fcs_size
    begin = len(out)
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        pos += 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("truncated raw block")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            out += data[pos:pos + 1] * size
            pos += 1
        elif kind == 2:
            if size > _MAX_BLOCK or pos + size > len(data):
                raise ZstdError("bad compressed block size")
            blk = data[pos:pos + size]
            lit, at = _literals(blk, 0, st)
            _sequences(blk, at, lit, out, st)
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content_size is not None and len(out) - begin != content_size:
        raise ZstdError("content size does not match the frame header")
    if has_checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out[begin:])) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data) -> bytes:
    """Decode every zstd frame in ``data`` and return the concatenated
    content."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    while pos < len(data):
        if len(data) - pos < 4:
            raise ZstdError("trailing bytes after the last frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic != _MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        pos = _frame(data, pos, out)
    return bytes(out)
