"""Pure-numpy reference implementation of the codec formats (the executable
spec; see FORMATS.md). The C++ library in native/codecs.cpp must produce
byte-identical output.

All serializations are little-endian with u64 headers and a u64 word stream;
bit 0 of word 0 is the first bit.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def _bit_length(x: int) -> int:
    return int(x).bit_length()


def _words_to_bytes(header: list[int], words: np.ndarray) -> bytes:
    head = np.array(header, dtype="<u8").tobytes()
    return head + words.astype("<u8").tobytes()


def _read_u64s(buf, offset: int, count: int) -> np.ndarray:
    return np.frombuffer(buf, dtype="<u8", count=count, offset=offset)


# ---------------------------------------------------------------------------
# fixed-width bit packing
# ---------------------------------------------------------------------------

def pack_fixed(values: np.ndarray, width: int) -> np.ndarray:
    """Pack n values of `width` bits each into a u64 word array."""
    n = len(values)
    total_bits = n * width
    num_words = (total_bits + 63) // 64
    words = np.zeros(num_words + 1, dtype=np.uint64)  # +1 scratch for spill
    if n:
        v = values.astype(np.uint64)
        starts = np.arange(n, dtype=np.uint64) * _U64(width)
        widx = (starts >> _U64(6)).astype(np.int64)
        shift = (starts & _U64(63))
        np.bitwise_or.at(words, widx, v << shift)
        # spill into the next word where shift + width > 64
        spill = shift.astype(np.int64) + width > 64
        if spill.any():
            rs = (_U64(64) - shift[spill])
            np.bitwise_or.at(words, widx[spill] + 1, v[spill] >> rs)
    return words[:num_words]


def unpack_fixed(words: np.ndarray, n: int, width: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    w = np.concatenate([words.astype(np.uint64), np.zeros(1, dtype=np.uint64)])
    starts = np.arange(n, dtype=np.uint64) * _U64(width)
    widx = (starts >> _U64(6)).astype(np.int64)
    shift = (starts & _U64(63))
    lo = w[widx] >> shift
    # bits from the following word where the field straddles
    rs = (_U64(64) - shift) & _U64(63)          # shift==0 -> rs=0 (no straddle)
    hi = np.where(shift == 0, _U64(0), w[widx + 1] << rs)
    mask = _U64(0xFFFFFFFFFFFFFFFF) if width == 64 else ((_U64(1) << _U64(width)) - _U64(1))
    return ((lo | hi) & mask).astype(np.uint64)


# ---------------------------------------------------------------------------
# compact_vector: [size u64][width u64][num_words u64][words...]
# ---------------------------------------------------------------------------

def cv_encode(values: np.ndarray) -> bytes:
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    mx = int(values.max()) if n else 0
    width = max(1, _bit_length(mx))
    words = pack_fixed(values, width)
    return _words_to_bytes([n, width, len(words)], words)


def cv_decode(buf, offset: int = 0):
    n, width, num_words = (int(x) for x in _read_u64s(buf, offset, 3))
    # a corrupt size must not drive the output allocation past the bits
    # actually present: n values of `width` bits need n*width <= 64*words
    # (the width-aware cap; a width-blind "n <= words*64 + 64" lets crafted
    # sizes through to an IndexError deep in unpack_fixed)
    if width > 64 or width < 1 or n * width > num_words * 64:
        raise ValueError("corrupt compact-vector header")
    words = _read_u64s(buf, offset + 24, num_words)
    consumed = 24 + 8 * num_words
    return unpack_fixed(words, n, width), consumed


# ---------------------------------------------------------------------------
# rice_sequence: [size u64][param u64][num_words u64][words...]
# value v -> (v>>l) one-bits, a zero bit, then l low bits (LSB first).
# l minimizes total bits; ties -> smaller l.
# ---------------------------------------------------------------------------

def _rice_pick_param(values: np.ndarray) -> int:
    n = len(values)
    if n == 0:
        return 0
    best_l, best_bits = 0, None
    for l in range(0, 64):
        total = int(np.sum(values >> _U64(l), dtype=np.uint64)) + n * (1 + l)
        if best_bits is None or total < best_bits:
            best_l, best_bits = l, total
    return best_l


def _or_bits(words: np.ndarray, start: int, value: int, nbits: int) -> None:
    """Scalar helper: OR the low nbits of value into the bitstream at start."""
    while nbits > 0:
        widx, shift = start >> 6, start & 63
        take = min(nbits, 64 - shift)
        words[widx] |= _U64((value & ((1 << take) - 1)) << shift)
        value >>= take
        start += take
        nbits -= take


def rice_encode(values: np.ndarray) -> bytes:
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    l = _rice_pick_param(values)
    if n:
        q = (values >> _U64(l)).astype(np.uint64)
        lens = q + _U64(1 + l)
        starts = np.zeros(n, dtype=np.uint64)
        starts[1:] = np.cumsum(lens)[:-1]
        total_bits = int(starts[-1] + lens[-1])
        num_words = (total_bits + 63) // 64
        words = np.zeros(num_words + 1, dtype=np.uint64)
        rem = values & ((_U64(1) << _U64(l)) - _U64(1)) if l else np.zeros(n, dtype=np.uint64)
        easy = lens <= _U64(64)
        if easy.any():
            # chunk = q ones | 0 | remainder, emitted as one <=64-bit piece
            qe, se, le = q[easy], starts[easy], lens[easy]
            ones = (_U64(1) << qe) - _U64(1)
            chunk = ones | (rem[easy] << (qe + _U64(1)))
            widx = (se >> _U64(6)).astype(np.int64)
            shift = se & _U64(63)
            np.bitwise_or.at(words, widx, chunk << shift)
            spill = shift.astype(np.int64) + le.astype(np.int64) > 64
            if spill.any():
                rs = _U64(64) - shift[spill]
                np.bitwise_or.at(words, widx[spill] + 1, chunk[spill] >> rs)
        hard = np.flatnonzero(~easy)
        for i in hard:  # rare: unary run longer than 63 bits
            start, qq = int(starts[i]), int(q[i])
            while qq > 0:
                take = min(qq, 63)
                _or_bits(words, start, (1 << take) - 1, take)
                start += take
                qq -= take
            start += 1  # the 0 terminator (words already zero)
            if l:
                _or_bits(words, start, int(rem[i]), l)
        words = words[:num_words]
    else:
        words = np.empty(0, dtype=np.uint64)
    return _words_to_bytes([n, l, len(words)], words)


def rice_decode(buf, offset: int = 0):
    """Vectorized decode: value i is q_i ones, a 0 terminator, then l payload
    bits. Terminator POSITIONS are recovered without a per-bit loop: over the
    array of zero-bit indices, the map g[k] = index of the first zero >=
    zeros[k] + 1 + l steps from one value's terminator to the next, and its
    orbit from zero is filled by pointer doubling (O(n log n) numpy work)."""
    n, l, num_words = (int(x) for x in _read_u64s(buf, offset, 3))
    # each value consumes >= 1+l bits (its terminator plus l payload bits) —
    # the l-aware cap; without the factor, crafted all-one-bit words with no
    # terminators walk an IndexError out of the pointer-doubling loop below
    if l > 63 or n * (1 + l) > num_words * 64:
        raise ValueError("corrupt rice header")
    words = _read_u64s(buf, offset + 24, num_words)
    consumed = 24 + 8 * num_words
    if n == 0:
        return np.empty(0, dtype=np.uint64), consumed
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    inv = bits == 0
    zeros = np.flatnonzero(inv).astype(np.int64)
    if len(zeros) < n:
        # every value owns a zero terminator bit — fewer zero bits than
        # values is unambiguously corrupt content (all-ones words would
        # otherwise crash the pointer-doubling loop / zeros[z] gather)
        raise ValueError("corrupt rice stream: missing terminators")
    if l == 0:
        z = np.arange(n, dtype=np.int64)  # no payload: zeros ARE terminators
    else:
        # zc[p] = zeros at positions <= p, so the index of the first zero at
        # position >= p is zc[p-1]; g steps terminator k to terminator k+1
        zc = np.cumsum(inv, dtype=np.int64)
        g = zc[np.minimum(zeros + l, len(zc) - 1)]
        np.minimum(g, len(zeros) - 1, out=g)  # clip once: overflow slots
        z = np.empty(n, dtype=np.int64)       # are never read, and g maps
        z[0] = 0                              # in-range -> in-range after it
        step = 1
        G = g
        while step < n:
            take = min(step, n - step)
            z[step:step + take] = G[z[:take]]
            G = G[G]
            step *= 2
    zpos = zeros[z]                        # bit position of terminator i
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    starts[1:] = zpos[:-1] + 1 + l
    q = (zpos - starts).astype(np.uint64)
    if l:
        # gather the l payload bits after each terminator straight from the
        # word array (same straddle math as unpack_fixed, arbitrary starts)
        rpos = (zpos + 1).astype(np.uint64)
        w = np.concatenate([words.astype(np.uint64),
                            np.zeros(1, dtype=np.uint64)])
        widx = (rpos >> _U64(6)).astype(np.int64)
        shift = rpos & _U64(63)
        lo = w[widx] >> shift
        rs = (_U64(64) - shift) & _U64(63)
        hi = np.where(shift == 0, _U64(0),
                      w[np.minimum(widx + 1, len(w) - 1)] << rs)
        rem = (lo | hi) & ((_U64(1) << _U64(l)) - _U64(1))
    else:
        rem = _U64(0)
    return ((q << _U64(l)) | rem).astype(np.uint64), consumed


# ---------------------------------------------------------------------------
# elias_fano: [n u64][universe u64][low_width u64][num_low_words u64]
#             [low words...][num_high_words u64][high words...]
# universe must be > max(values); values must be non-decreasing.
# high bit i-th value: bit ((v>>l) + i) set in the high bit vector.
# ---------------------------------------------------------------------------

def _ef_low_bits(n: int, universe: int) -> int:
    if n == 0:
        return 0
    q = universe // n
    return max(0, _bit_length(q) - 1)


def ef_encode(values: np.ndarray, universe: int) -> bytes:
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    universe = max(int(universe), 1)
    l = _ef_low_bits(n, universe)
    if l:
        low_words = pack_fixed(values & ((_U64(1) << _U64(l)) - _U64(1)), l)
    else:
        low_words = np.empty(0, dtype=np.uint64)
    high_bits = n + (universe >> l) + 1
    num_high_words = (high_bits + 63) // 64
    high = np.zeros(num_high_words, dtype=np.uint64)
    if n:
        pos = (values >> _U64(l)) + np.arange(n, dtype=np.uint64)
        np.bitwise_or.at(high, (pos >> _U64(6)).astype(np.int64),
                         _U64(1) << (pos & _U64(63)))
    head = np.array([n, universe, l, len(low_words)], dtype="<u8").tobytes()
    mid = low_words.astype("<u8").tobytes()
    tail = np.array([num_high_words], dtype="<u8").tobytes() + high.astype("<u8").tobytes()
    return head + mid + tail


def ef_decode(buf, offset: int = 0):
    n, universe, l, num_low = (int(x) for x in _read_u64s(buf, offset, 4))
    if l > 63:
        raise ValueError("corrupt Elias-Fano header: low width > 63")
    pos = offset + 32
    low_words = _read_u64s(buf, pos, num_low)
    pos += 8 * num_low
    num_high = int(_read_u64s(buf, pos, 1)[0])
    pos += 8
    high = _read_u64s(buf, pos, num_high)
    pos += 8 * num_high
    consumed = pos - offset
    if n == 0:
        return np.empty(0, dtype=np.uint64), consumed
    # every element sets one high bit and consumes l low bits: a corrupt
    # size cannot allocate past the bits actually present in the buffer
    if n > num_high * 64 or (l and n * l > num_low * 64):
        raise ValueError("corrupt Elias-Fano header: size exceeds "
                         "encoded bits")
    bits = np.unpackbits(high.view(np.uint8), bitorder="little")
    set_pos = np.flatnonzero(bits)
    if len(set_pos) < n:
        raise ValueError("corrupt Elias-Fano data: fewer high bits than "
                         "elements")
    set_pos = set_pos[:n].astype(np.uint64)
    highs = set_pos - np.arange(n, dtype=np.uint64)
    lows = unpack_fixed(low_words, n, l) if l else np.zeros(n, dtype=np.uint64)
    return ((highs << _U64(l)) | lows).astype(np.uint64), consumed
