"""jermp/bits-layout codecs (RECONSTRUCTED) — the stretch-goal compat path.

The reference's matrix artifacts are raw concatenations of
`bits::compact_vector::save` / `bits::rice_sequence<>::save` /
`bits::elias_fano<>::save` blobs (writer pairwise_comp_optimized.cpp:
724-791, readers read_pc_mat_cmp.cpp:133-143, 336-343, 484-487, 625-662).
That library (github.com/hasin-abrar/bits, fork of jermp/bits) is an EMPTY
submodule in the reference snapshot, so this module implements the layout
as reconstructed from the public jermp/bits + jermp/essentials semantics:

- essentials serialization: POD members as raw little-endian bytes;
  std::vector<T> as [u64 element count][raw data]. Vector lengths are part
  of the stream, so DECODE here is tolerant of word-padding differences.
- compact_vector: members (m_size u64, m_width u64, m_mask u64,
  m_bits vec<u64>); values packed LSB-first at consecutive width-bit
  offsets; width >= 1; mask == (1<<width)-1 (2^64-1 at width 64) — the
  mask/width identity is also the format-detection invariant
  (:func:`sniff_cv`).
- bit_vector: (m_size u64 in BITS, m_bits vec<u64>).
- darray (select index): (m_positions u64, m_block_inventory vec<i64>,
  m_subblock_inventory vec<u16>, m_overflow_positions vec<u64>), built with
  the classic succinct/ds2i parameters: 1024 positions per block, subblock
  stride 32, dense-block span bound 1<<16. Decoders SKIP it (lengths are in
  the stream); encoders build it faithfully so a real bits reader can
  select.
- rice_sequence: (m_high_bits bit_vector, m_high_bits_d1 darray,
  m_low_bits compact_vector). Value v is split at the optimal Rice
  parameter l (= m_low_bits width): the high part v>>l is unary-coded as
  that many ZEROS then a terminating ONE in the high bit_vector; the low l
  bits go to the compact_vector.
- elias_fano<false,false>: (m_universe u64, m_high_bits bit_vector,
  m_high_bits_d1 darray, m_low_bits compact_vector), with
  l = max(0, floor(log2(universe/n))); bit (v>>l)+i set for the i-th value;
  an instance built with index_zeros=true carries a second darray, which
  the decoder detects structurally and skips.

FORMATS.md records this reconstruction and its uncertainty; conformance
against artifacts written by the actual library is untestable here (the
submodule is unpinned), so the gate is byte-level hand fixtures + full
round-trips through the shard reader's autodetect.
"""

from __future__ import annotations

import numpy as np

from .pyref import pack_fixed, unpack_fixed

_U64 = np.uint64

BLOCK_SIZE = 1024           # darray positions per block-inventory entry
SUBBLOCK_SIZE = 32
MAX_IN_BLOCK_DISTANCE = 1 << 16


def _vec(data: np.ndarray) -> bytes:
    return np.uint64(len(data)).tobytes() + np.ascontiguousarray(data).tobytes()


def _read_u64(buf, off):
    return int(np.frombuffer(buf, dtype="<u8", count=1, offset=off)[0]), off + 8


def _read_vec(buf, off, dtype):
    n, off = _read_u64(buf, off)
    itemsize = np.dtype(dtype).itemsize
    # validate the untrusted length against the bytes actually present
    # BEFORE frombuffer: a corrupted u64 near 2^64 otherwise surfaces as an
    # OverflowError (C ssize_t), not a clean parse error (found by
    # tools/fuzz_native.py fuzz_bitscompat)
    if n * itemsize > len(buf) - off:
        raise ValueError("bits vector length exceeds the buffer")
    arr = np.frombuffer(buf, dtype=dtype, count=n, offset=off)
    return arr, off + n * itemsize


# ---------------------------------------------------------------- compact_vector
def cv_encode(values: np.ndarray, width: int | None = None) -> bytes:
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if width is None:
        width = max(1, int(values.max()).bit_length()) if n else 1
    mask = (1 << width) - 1 if width < 64 else (1 << 64) - 1
    words = pack_fixed(values, width)
    head = np.array([n, width, mask], dtype="<u8").tobytes()
    return head + _vec(words.astype("<u8"))


def cv_decode(buf, offset: int = 0):
    """-> (values uint64 array, consumed, width)."""
    size, off = _read_u64(buf, offset)
    width, off = _read_u64(buf, off)
    mask, off = _read_u64(buf, off)
    expect = (1 << width) - 1 if width < 64 else (1 << 64) - 1
    if width == 0 or width > 64 or mask != expect:
        raise ValueError("not a bits::compact_vector blob")
    words, off = _read_vec(buf, off, "<u8")
    if len(words) * 64 < size * width:
        raise ValueError("bits::compact_vector words underflow")
    return unpack_fixed(words.astype(np.uint64), size, width), off - offset, width


# ---------------------------------------------------------------- bit_vector
def _bv_encode(bits_len: int, words: np.ndarray) -> bytes:
    return np.uint64(bits_len).tobytes() + _vec(words.astype("<u8"))


def _bv_decode(buf, offset):
    size, off = _read_u64(buf, offset)
    words, off = _read_vec(buf, off, "<u8")
    if len(words) * 64 < size:
        raise ValueError("bits::bit_vector words underflow")
    return size, words.astype(np.uint64), off


# ---------------------------------------------------------------- darray
def _darray_encode(positions: np.ndarray) -> bytes:
    """Faithful succinct/ds2i darray builder over sorted set-bit positions
    (so a real bits reader can select into our encodes)."""
    positions = np.asarray(positions, dtype=np.int64)
    block_inv: list[int] = []
    sub_inv: list[int] = []
    overflow: list[int] = []
    for s in range(0, len(positions), BLOCK_SIZE):
        blk = positions[s:s + BLOCK_SIZE]
        if int(blk[-1]) - int(blk[0]) < MAX_IN_BLOCK_DISTANCE:
            block_inv.append(int(blk[0]))
            sub_inv.extend((blk[::SUBBLOCK_SIZE] - blk[0]).tolist())
        else:
            block_inv.append(-len(overflow) - 1)
            overflow.extend(blk.tolist())
            sub_inv.extend([0xFFFF] * len(blk[::SUBBLOCK_SIZE]))
    out = np.uint64(len(positions)).tobytes()
    out += _vec(np.asarray(block_inv, dtype="<i8"))
    out += _vec(np.asarray(sub_inv, dtype="<u2"))
    out += _vec(np.asarray(overflow, dtype="<u8"))
    return out


def _darray_skip(buf, offset):
    """Decoders derive everything from the bit_vector; the darray is
    length-prefixed so it can be skipped structurally."""
    npos, off = _read_u64(buf, offset)
    blocks, off = _read_vec(buf, off, "<i8")
    subs, off = _read_vec(buf, off, "<u2")
    overflow, off = _read_vec(buf, off, "<u8")
    # structural sanity (also drives the elias_fano darray-count sniffing)
    if len(subs) > max(1, npos) or len(overflow) > npos:
        raise ValueError("implausible darray")
    return npos, off


# ---------------------------------------------------------------- rice_sequence
def _optimal_rice_param(values: np.ndarray) -> int:
    n = len(values)
    if n == 0:
        return 1
    best_l, best_bits = 1, None
    for l in range(1, 64):
        total = int(np.sum(values >> _U64(l), dtype=np.uint64)) + n * (1 + l)
        if best_bits is None or total < best_bits:
            best_l, best_bits = l, total
    return best_l


def rice_encode(values: np.ndarray, l: int | None = None) -> bytes:
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if l is None:
        l = _optimal_rice_param(values)
    if n:
        q = (values >> _U64(l)).astype(np.int64)
        ones_pos = np.cumsum(q + 1) - 1       # i-th ONE terminates value i
        total_bits = int(ones_pos[-1]) + 1
        words = np.zeros((total_bits + 63) // 64, dtype=np.uint64)
        np.bitwise_or.at(words, ones_pos >> 6,
                         _U64(1) << (ones_pos.astype(np.uint64) & _U64(63)))
        lows = values & ((_U64(1) << _U64(l)) - _U64(1))
        darr = _darray_encode(ones_pos)
    else:
        total_bits, words = 0, np.empty(0, dtype=np.uint64)
        lows = values
        darr = _darray_encode(np.empty(0, dtype=np.int64))
    return (_bv_encode(total_bits, words) + darr
            + cv_encode(lows, width=l))


def rice_decode(buf, offset: int = 0):
    """-> (values uint64 array, consumed)."""
    size, words, off = _bv_decode(buf, offset)
    npos, off = _darray_skip(buf, off)
    lows, used, l = cv_decode(buf, off)
    off += used
    n = len(lows)
    if n:
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:size]
        ones = np.flatnonzero(bits)
        if len(ones) < n:
            raise ValueError("bits::rice_sequence ones underflow")
        ones = ones[:n].astype(np.int64)
        q = np.diff(np.concatenate([[-1], ones])) - 1
        vals = (q.astype(np.uint64) << _U64(l)) | lows
    else:
        vals = np.empty(0, dtype=np.uint64)
    return vals, off - offset


# ---------------------------------------------------------------- elias_fano
def _ef_low_bits(n: int, universe: int) -> int:
    if n == 0 or universe <= n:
        return 0
    return max(0, (universe // n).bit_length() - 1)


def ef_encode(values: np.ndarray, universe: int,
              index_zeros: bool = False) -> bytes:
    """index_zeros=True additionally emits the select0 darray (the
    elias_fano<true,...> template instantiation's extra member)."""
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    universe = max(int(universe), 1)
    l = _ef_low_bits(n, universe)
    if n:
        high_pos = ((values >> _U64(l)) + np.arange(n, dtype=np.uint64)) \
            .astype(np.int64)
        total_bits = n + (universe >> l) + 1
        words = np.zeros((total_bits + 63) // 64, dtype=np.uint64)
        np.bitwise_or.at(words, high_pos >> 6,
                         _U64(1) << (high_pos.astype(np.uint64) & _U64(63)))
        darr = _darray_encode(high_pos)
    else:
        total_bits = universe + 1
        words = np.zeros((total_bits + 63) // 64, dtype=np.uint64)
        darr = _darray_encode(np.empty(0, dtype=np.int64))
    if index_zeros:
        bits = np.unpackbits(words.view(np.uint8),
                             bitorder="little")[:total_bits]
        darr += _darray_encode(np.flatnonzero(bits == 0).astype(np.int64))
    if l:
        low = cv_encode(values & ((_U64(1) << _U64(l)) - _U64(1)), width=l)
    else:
        low = cv_encode(np.empty(0, dtype=np.uint64), width=1)
    return np.uint64(universe).tobytes() + _bv_encode(total_bits, words) \
        + darr + low


def ef_decode(buf, offset: int = 0):
    """-> (values uint64 array, consumed). Skips one or two darray members
    (an index_zeros=true instance carries a select0 index as well)."""
    universe, off = _read_u64(buf, offset)
    size, words, off = _bv_decode(buf, off)
    npos, off = _darray_skip(buf, off)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:size]
    ones = np.flatnonzero(bits).astype(np.uint64)
    n = len(ones)

    def finish(off_local):
        """Parse the low-bits cv at off_local and VALIDATE it against the
        high bits (the strong invariant: the cv holds exactly one low part
        per value, or is empty when l == 0)."""
        lows, used, l = cv_decode(buf, off_local)
        if len(lows) and len(lows) != n:
            raise ValueError("bits::elias_fano low/high size mismatch")
        ll = l if len(lows) else 0
        highs = ones - np.arange(n, dtype=np.uint64)
        if ll and len(lows):
            vals = (highs << _U64(ll)) | lows
        else:
            vals = highs
        return vals.astype(np.uint64), off_local + used - offset

    # One or two darray members precede the low bits (index_zeros adds a
    # select0 index). Header sniffing alone is ambiguous — a darray whose
    # first fields happen to satisfy the cv mask/width identity parses as a
    # cv — so decide by FULL validation: accept the one-darray reading only
    # if its cv also passes the low/high size invariant, else re-read with
    # a second darray skipped.
    try:
        return finish(off)
    except ValueError:
        _, off2 = _darray_skip(buf, off)
        return finish(off2)


# ---------------------------------------------------------------- sniffing
def decoders(layout: str):
    """(cv_decode, rice_decode) with the package-codec signatures
    (-> (values, consumed)) for a codec layout ('native' = FORMATS.md
    serialization, 'bits' = this module's reconstructed jermp/bits
    layout). THE single adaptation point — the shard reader, the legacy
    readers, and detect_two below all use this one, so the acceptance
    rules genuinely cannot diverge."""
    if layout == "bits":
        return (lambda b, o=0: cv_decode(b, o)[:2], rice_decode)
    from . import cv_decode as _ncv, rice_decode as _nrice
    return _ncv, _nrice


def detect_two(blob, kind: str, validate=None):
    """Layout autodetect for an index file made of two concatenated blobs
    of `kind` ('cv' | 'rice'): fully parse under the 'native' (package
    serialization, FORMATS.md) then 'bits' (this module) hypothesis — the
    winner must consume the file exactly and pass `validate(first, second)`
    if given. Header sniffing alone is ambiguous (a width-1 native blob
    collides with the bits mask identity), hence the full parse.

    -> (layout, first, second). Shared by the shard reader and the legacy
    readers so the acceptance rules cannot diverge."""
    for layout in ("native", "bits"):
        dec = decoders(layout)[0 if kind == "cv" else 1]
        try:
            a, c1 = dec(blob, 0)
            b, c2 = dec(blob, c1)
        except Exception:
            continue
        if c1 + c2 == len(blob) and (validate is None or validate(a, b)):
            return layout, a, b
    raise ValueError(f"unrecognized {kind}+{kind} index codec layout")


def sniff_cv(buf, offset: int = 0) -> str:
    """'bits' | 'native' | 'unknown' for the blob at offset.

    bits::compact_vector carries the mask/width identity at words 1-2;
    the native layout's third word is its word count. Both are validated
    structurally against the buffer length."""
    if len(buf) - offset < 24:
        return "unknown"
    h = np.frombuffer(buf, dtype="<u8", count=3, offset=offset)
    size, width, third = (int(x) for x in h)
    if 1 <= width <= 64:
        expect_mask = (1 << width) - 1 if width < 64 else (1 << 64) - 1
        if third == expect_mask and len(buf) - offset >= 32:
            nwords = int(np.frombuffer(buf, dtype="<u8", count=1,
                                       offset=offset + 24)[0])
            if offset + 32 + 8 * nwords <= len(buf) \
                    and nwords * 64 >= size * width:
                return "bits"
        if third * 64 >= size * width and offset + 24 + 8 * third <= len(buf):
            return "native"
    return "unknown"
