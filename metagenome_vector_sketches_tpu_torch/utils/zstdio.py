"""In-process zstd for the reference's legacy artifacts.

The reference leaves historical matrix shards compressed on disk as
`<file>.zst` and shells out to `zstd -d` before every read
(read_pc_mat.cpp:10-13; writers compress with `zstd -f`,
pairwise_comp_optimized.cpp:334-338, pairwise_comp_optimized_16bits.cpp:
318-322). We decompress in-process — no subprocess, no temp files:
the `zstandard` module when present, else a ctypes binding to the system
libzstd (one-shot when the frame records its content size, streaming
otherwise).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

_ZSTD_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2 ** 64 - 2

_backend = None


def _load_libzstd():
    for name in ("libzstd.so.1", "libzstd.so",
                 ctypes.util.find_library("zstd") or ""):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        u64, sz, p = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_isError.argtypes = [sz]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getFrameContentSize.argtypes = [p, sz]
        lib.ZSTD_getFrameContentSize.restype = u64
        lib.ZSTD_decompress.argtypes = [p, sz, p, sz]
        lib.ZSTD_decompress.restype = sz
        lib.ZSTD_compressBound.argtypes = [sz]
        lib.ZSTD_compressBound.restype = sz
        lib.ZSTD_compress.argtypes = [p, sz, p, sz, ctypes.c_int]
        lib.ZSTD_compress.restype = sz
        return lib
    return None


def _get_backend():
    global _backend
    if _backend is None:
        try:
            import zstandard
            _backend = ("zstandard", zstandard)
        except ImportError:  # pragma: no cover - zstandard is baked in here
            lib = _load_libzstd()
            _backend = ("libzstd", lib) if lib is not None else ("none", None)
    return _backend


def available() -> bool:
    return _get_backend()[0] != "none"


def compress(data: bytes, level: int = 3) -> bytes:
    kind, impl = _get_backend()
    if kind == "zstandard":
        return impl.ZstdCompressor(level=level).compress(data)
    if kind == "libzstd":
        bound = impl.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(bound)
        n = impl.ZSTD_compress(out, bound, data, len(data), level)
        if impl.ZSTD_isError(n):
            raise ValueError("zstd compression failed")
        return out.raw[:n]
    raise RuntimeError("no zstd backend available")


def _decompress_libzstd(impl, data: bytes) -> bytes:
    size = impl.ZSTD_getFrameContentSize(data, len(data))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame")
    impl.ZSTD_findFrameCompressedSize.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_size_t]
    impl.ZSTD_findFrameCompressedSize.restype = ctypes.c_size_t
    frame_len = impl.ZSTD_findFrameCompressedSize(data, len(data))
    one_frame = (not impl.ZSTD_isError(frame_len)
                 and frame_len == len(data))
    # sanity-clamp the untrusted content-size header before allocating:
    # a corrupt frame claiming terabytes must be rejected, not zero-filled
    # (zstd's own max ratio is well under this; cf. sigscan.cpp kMaxInflate)
    max_plausible = len(data) * 2048 + (1 << 24)
    if (size != _ZSTD_CONTENTSIZE_UNKNOWN and one_frame
            and size <= max_plausible):
        # fast path only when the single frame spans the whole input —
        # pzstd / concatenated .zst files are MULTI-frame (valid zstd) and
        # the content-size header only describes the first frame
        out = ctypes.create_string_buffer(max(1, size))
        n = impl.ZSTD_decompress(out, size, data, len(data))
        if impl.ZSTD_isError(n) or n != size:
            raise ValueError("zstd decompression failed")
        return out.raw[:n]
    # streaming path: handles unknown content sizes AND multi-frame input
    # (ZSTD_decompressStream starts the next frame after each finishes)
    impl.ZSTD_createDCtx.restype = ctypes.c_void_p
    impl.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
    dctx = impl.ZSTD_createDCtx()

    class _Buf(ctypes.Structure):
        _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                    ("pos", ctypes.c_size_t)]

    impl.ZSTD_decompressStream.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(_Buf),
                                           ctypes.POINTER(_Buf)]
    impl.ZSTD_decompressStream.restype = ctypes.c_size_t
    src = ctypes.create_string_buffer(data, len(data))
    inb = _Buf(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    chunks = []
    try:
        chunk = ctypes.create_string_buffer(1 << 20)
        rc = 0
        while True:
            outb = _Buf(ctypes.cast(chunk, ctypes.c_void_p), len(chunk), 0)
            rc = impl.ZSTD_decompressStream(dctx, ctypes.byref(outb),
                                            ctypes.byref(inb))
            if impl.ZSTD_isError(rc):
                raise ValueError("zstd stream decompression failed")
            chunks.append(chunk.raw[:outb.pos])
            # keep draining while input remains OR the output chunk came
            # back exactly full (zstd may still hold buffered output)
            if inb.pos >= inb.size and outb.pos < outb.size:
                break
        if rc != 0:
            # input exhausted mid-frame: rc is the frame's remaining-byte
            # hint — returning the partial data would silently truncate a
            # legacy artifact cut by a failed copy
            raise ValueError("truncated zstd stream (incomplete frame)")
    finally:
        impl.ZSTD_freeDCtx(dctx)
    return b"".join(chunks)


def decompress(data: bytes) -> bytes:
    kind, impl = _get_backend()
    if kind == "zstandard":
        # per-frame decompressobj loop: reads across frames (pzstd output
        # and concatenated .zst are MULTI-frame valid zstd) AND verifies
        # each frame completed — stream_reader(read_across_frames=True)
        # silently returns partial data for an input truncated mid-frame
        out = []
        remaining = data
        dec = impl.ZstdDecompressor()
        while remaining:
            dobj = dec.decompressobj()
            out.append(dobj.decompress(remaining))
            if not dobj.eof:
                raise ValueError("truncated zstd stream (incomplete frame)")
            remaining = dobj.unused_data
        return b"".join(out)
    if kind == "libzstd":
        return _decompress_libzstd(impl, data)
    raise RuntimeError("no zstd backend available")


def read_maybe_zst(path: str) -> bytes:
    """The legacy readers' file access: plain file if present, else
    `<path>.zst` decompressed in-process (the state the reference leaves
    artifacts in, read_pc_mat.cpp:10-13)."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    z = path + ".zst"
    if os.path.exists(z):
        with open(z, "rb") as f:
            return decompress(f.read())
    raise FileNotFoundError(path)
