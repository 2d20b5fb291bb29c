"""The pairwise engine: one thresholded all-vs-all matrix shard, on the
device.

Port of the JAX package's fused and two-phase engines
(``metagenome_vector_sketches_tpu/matrix/compute.py:140-257, 307-388,
391-520, 788-1105, 1107-1273``) and of its MinHash shard (``:1275-1333``).
The fused engine:

1. Staging: vectors.bin is read in chunks of its own dtype by reader
   threads into a ring of page-locked host buffers, each chunk is copied
   to the device on a copy stream and split into (P, Npad, d_pad) int8
   Karatsuba planes there, the reads, copies and splits overlapped
   (:func:`_upload_rows`), which also sums each row's squares plane by
   plane; thresholds are the text-parsed squared norms less the float32
   combine error that those energies certify for the row
   (:func:`_thresholds`), 1e30 on pad rows.
2. Sweep: kernel APPEND over the shard's TRIANGLE tile grid (only column
   tiles c >= r inside the shard's own row-tile range; mirrors are
   re-emitted by kernel X) with self-pairs masked, over a tile list on the
   card, one range of it at a time. When a range's survivor total exceeds
   the buffer's capacity, the range is rerun at exactly that capacity
   (kernel APPEND counts past its cap); when the exact size would break
   the buffer budget, the range is halved instead.
3. Retention: kernel X's retention epilogue (ops.pairwise.pair_keep)
   combines each survivor's exact int64 dot on the card, applies the
   shard's range filter and the reference's exact retention (int32 or
   int16 semantics), and emits the mirror twin of each survivor whose
   transposed tile was not swept; self-pairs go through it on (i, i).
4. One small device->host copy per round (the kept pairs and three
   counters); the host appends them and writes the shard with the shared
   writer.

The staged planes stay in a one-slot residency cache (JAX ``_RESIDENT``,
``:273-388``), so the next shard of the same db skips step 1;
:func:`clear_device_cache` empties it, and a run on another db evicts it
before anything is measured or staged. The db's norms are parsed once a
process into ``io.textparse``'s slot, which :func:`clear_device_cache`
empties too.

When the planes exceed the device budget, the streaming engine
(:func:`_compute_streaming`) keeps a group of the shard's row tiles on the
device and streams windows of column tiles past it (the full rectangle,
two operands, self-pairs masked through kernel APPEND's diagonal
offset). Every engine stages its rows through step 1's reader: the
streaming engines stage a row range of the file at a time.

The two-phase engine (``engine="two_phase"``, and every tile whose square
is not a multiple of 32, as in the JAX package; resident:
:func:`_compute_device_resident_two_phase`, streaming:
:func:`_compute_streaming_two_phase`) is the path of the JAX package's one
Pallas kernel, ``pallas_sweep_counts``:

1. Counts sweep: kernel COUNT over the FULL rectangle of the shard's row
   tiles x every column tile (ops.pallas_pairwise.count_tiles; the tile
   list goes to the card once, each tile's survivors are summed there).
2. Hot-tile extraction: the tiles with survivors, in chunks whose summed
   counts fit CANDIDATE_BUDGET_BYTES, through kernel APPEND with the
   self-pairs kept, at the capacity the counts give (a slot that finds
   more is rerun at its exact total). Every unordered pair is found in
   both orders: nothing is mirrored on the host.
3. Finalize: the candidates' (row, column) pairs come to the host; those in
   the shard's rows get exact dots from the vectors memmap
   (``finalize="host"``, pairwise_math.exact_dots_host) or from kernel X
   on the staged planes (``"device"``, ops.pairwise.exact_dots_device),
   then the same exact retention and writer.

With ``mesh`` (parallel.mesh.Mesh), every engine runs tile-data-parallel
over its slots (JAX ``compute.py:202-205, 383, 811, 1167-1259``): the planes
are replicated to every slot and the tiles are split into per-slot
blocks (parallel.engine.MeshSweepOps); the shard is byte-identical to the
single-device one. Without a mesh the engine runs on a 1-slot mesh of
``device``. ``gate`` changes nothing here: kernel APPEND already emits
nothing for a tile without survivors.
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._device import resolve_device
from ..io import textparse
from ..io.dbfolder import DbFolder
from ..parallel.engine import MeshSweepOps
from ..parallel.mesh import Mesh
from ..io.hashes import parse_hashes_file
from ..utils.log import log
from ..utils.profiling import entry_span, stage
from .writer import write_shard
from ..ops import minhash
from ..ops import pairwise as pw
from ..ops import pairwise_math as pm

# per-shard stage walls (ms) and counters of the LAST compute_pairwise_shard
# call (the JAX engine's keys, and four of its own), each wall with the
# profiler span that times the same block (utils.profiling.stage; the call
# itself is the span mvs.shard#<n>):
# - entry_ms (mvs.shard.entry): the checks, the db's metadata, the norms
#   parse and scan_max_abs, before total_ms starts; norms_parse_ms
#   (mvs.shard.norms_parse) the vector_norms.txt parse inside it;
# - total_ms (no span): from the end of the entry to the end of the write;
# - stage_ms (mvs.shard.stage): the staging of the rows (_upload_rows),
#   synchronised once at its end. Inside it: stage_h2d_ms (the span
#   mvs.shard.stage_h2d encloses the enqueue) and stage_decompose_ms
#   (mvs.shard.decompose), on CUDA the copies' and the limb
#   decompositions' summed device time (CUDA events, read once when each
#   staging ends), on the CPU their walls; stage_wait_ms
#   (mvs.shard.stage_wait): the calling thread's waits for a host buffer's
#   fill or a buffer's copy; stage_read_ms: the file reads' wall, summed
#   over chunks (the preadv fills on the reader threads, no span);
#   stage_bytes: the bytes of vectors.bin read for staging. All five are
#   counted by the one stager (_upload_rows), for every engine, and are 0
#   on a residency hit; slack_max (no span): the largest per-row slack
#   sigma_i of the rows staged for the call, on the dot/d scale (a pair's
#   slack is SLACK_INFLATE * (sigma_i + sigma_j); _thresholds), the
#   residency slot's on a hit;
# - sweep_ms (mvs.shard.sweep, one span a round): kernel APPEND,
#   synchronised;
# - extract_ms (mvs.shard.extract): the fused engines' kernel X with its
#   retention epilogue, the wait for it and the copy of the kept pairs;
# - combine_ms (mvs.shard.combine) and mirror_ms (mvs.shard.mirror): no
#   engine enters them since kernel X combines and mirrors on the card
#   (they read 0.0);
# - finalize_ms (mvs.shard.finalize): the fused engines' append of the kept
#   pairs; the two-phase engine's exact filter on the host;
# - write_ms (mvs.shard.write): the writer; inside it write_order_ms
#   (mvs.write.order), the ordering of the triples, write_quantize_ms
#   (mvs.write.quantize), their quantisation, write_codec_ms
#   (mvs.write.codec), the codecs and the files, and the counter
#   write_presorted (1 when they came in order and nothing was sorted).
# Counters: candidates, emitted, pairs_written, mode, readback_bytes (the
# bytes the fused engines copy device->host from kernel X: kept pairs and
# counters), sweep_reruns and keep_reruns (the fused engines' slot ranges
# whose kernel APPEND survivors, or whose kernel X kept pairs, overflowed
# their buffer, so that the kernel ran again at the exact count; summed
# over the rounds). The streaming engine
# adds row_groups, windows and tiles_swept. The two-phase engine's
# sweep_ms is its counts sweep (plus, streaming, the row tile's staging),
# its extract_ms the extraction's launches and copies, and its finalize_ms
# the exact filter with its exact dots; it adds hot_tiles (tiles the counts
# sweep found survivors in, which the extraction sweeps again), reruns
# (slot blocks whose APPEND total exceeded the capacity their counts gave)
# and, streaming, windows. compute_minhash_shard replaces them with the
# MinHash stages: stage_ms (mvs.minhash.stage: the parse, sort and split,
# 0 on a slot hit), heavy_ms, light_ms, keep_ms (ops.minhash.shard_triples'
# walls and counters), write_ms (mvs.minhash.write; with write_order_ms,
# write_quantize_ms, write_codec_ms and write_presorted inside it, as
# above), stage_bytes (the hashes file's bytes parsed, 0 on a hit) and
# pairs_written.
LAST_STAGES: dict = {}

# bytes of vectors (of the rows' own dtype) per host->device staging chunk
STAGE_CHUNK_BYTES = 64 << 20
# host buffers of a chunk in the staging ring (page-locked on CUDA)
STAGE_RING = 3
# threads that fill one host buffer with vectors.bin reads
STAGE_READERS = min(4, os.cpu_count() or 1)
# the per-row slack's inflation: lam of _thresholds' t_i, which covers the
# float32 threshold arithmetic's roundings and SLACK_REL's shrinking of
# the slack it takes away
SLACK_INFLATE = 1.0 + 2.0 ** -16
# first capacity (pairs) of the survivor buffer; grows to the exact size
SWEEP_CAP_START = 1 << 22
# first capacity (pairs) of kernel X's kept-pair buffer, which also holds
# at least 1/KEEP_SHARE of a round's candidates; grows to the largest kept
# count of the shard's rounds (a round that keeps more reruns exactly)
KEEP_CAP_START = 1 << 16
KEEP_SHARE = 32
# bound on the candidate buffers (bytes) before a chunk of tiles is halved
# instead of rerun at its exact size
CANDIDATE_BUDGET_BYTES = 4 << 30

# tile edges already reported as rounded (each is logged once a process)
_ROUNDED_TILES: set = set()

# one-slot device-residency cache (the JAX package's _RESIDENT): a process
# that writes several shards of one db re-uses its staged planes and
# thresholds instead of staging them again for every shard. Only the
# resident engine fills and reads it.
_RESIDENT: dict = {}


# one-slot residency cache of the MinHash path: the staged sets of one
# hashes file (compute_minhash_shard, stage_minhash_sets), so that the
# shards of one collection parse, sort and split it once a process
_SETS: dict = {}


def clear_device_cache() -> None:
    _RESIDENT.clear()
    _SETS.clear()
    textparse.clear_norms()


def _resident_key(db, total, tile, L, d, max_abs, mesh) -> tuple:
    """The slot's key (the JAX package's): the db files' path, mtimes and
    sizes, the staging parameters, and the mesh's devices."""
    vec_path = os.path.join(db.path, "vectors.bin")
    norm_path = os.path.join(db.path, "vector_norms.txt")
    return (os.path.abspath(vec_path),
            os.path.getmtime(vec_path), os.path.getsize(vec_path),
            os.path.getmtime(norm_path), os.path.getsize(norm_path),
            total, tile, L, d, max_abs, mesh.key)


def _keep_only(key) -> int:
    """Empty the slot unless it holds ``key``; an evicted slot's device
    memory goes back to the driver, so the budget and the staging see the
    cards without it (two dbs' planes never sit on a card together).
    -> bytes the kept slot holds on each of its cards (0 when empty)."""
    if _RESIDENT.get("key") == key:
        planes, thr = _RESIDENT["value"]
        return planes.numel() * planes.element_size() + 4 * thr.numel()
    if _RESIDENT:
        on_cuda = _RESIDENT["value"][0].is_cuda
        _RESIDENT.clear()
        if on_cuda:
            torch.cuda.empty_cache()
    return 0


def sweep_tile(tile_rows: int, device) -> int:
    """The sweep's tile edge on ``device``: tile_rows itself on the CPU; on
    CUDA rounded UP to a multiple of the kernels' block (128), logged
    once. The shard does not depend on the tile (the writer orders the
    pairs)."""
    if torch.device(device).type != "cuda" or tile_rows % pw.SWEEP_BLOCK == 0:
        return tile_rows
    tile = pw.pad_rows(tile_rows, device)
    if tile_rows not in _ROUNDED_TILES:
        _ROUNDED_TILES.add(tile_rows)
        log(f"tile_rows={tile_rows} rounded up to {tile} (the kernels "
            f"take multiples of {pw.SWEEP_BLOCK} on CUDA)")
    return tile


def _reset_stages():
    LAST_STAGES.clear()
    LAST_STAGES.update(stage_ms=0.0, sweep_ms=0.0, extract_ms=0.0,
                       finalize_ms=0.0, write_ms=0.0,
                       # candidates = survivors of the sweep (self-pairs
                       # included); emitted = pairs handed to the exact
                       # test inside this shard's row range, mirror twins
                       # included
                       candidates=0, emitted=0, pairs_written=0,
                       stage_decompose_ms=0.0, stage_h2d_ms=0.0,
                       stage_read_ms=0.0, stage_wait_ms=0.0,
                       stage_bytes=0, slack_max=0.0, entry_ms=0.0,
                       norms_parse_ms=0.0,
                       combine_ms=0.0, mirror_ms=0.0, readback_bytes=0,
                       sweep_reruns=0, keep_reruns=0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scan_max_abs(db: DbFolder, chunk: int = 8192) -> int:
    """Global max |component|: max_component.txt when the db has a fresh
    one, else one streaming scan of vectors.bin."""
    cached = db.max_component()
    if cached is not None:
        return cached
    n = db.total_vectors_from_bin()
    m = 0
    for s in range(0, n, chunk):
        block = db.load_vectors(s, min(s + chunk, n))
        if block.size:
            m = max(m, int(block.max()), -int(block.min()))
    return m


def shard_is_complete(output_folder: str, shard_idx: int) -> bool:
    """A shard is complete when its neighbor_start.bin (written last by the
    writer) exists — the unit of checkpoint/restart."""
    return os.path.exists(os.path.join(output_folder, f"shard_{shard_idx}",
                                       "neighbor_start.bin"))


@entry_span("shard")
def compute_pairwise_shard(db_folder: str, output_folder: str,
                           num_shards: int = 1, shard_idx: int = 0,
                           tile_rows: int = 2048, tile_cols: int = 2048,
                           device_budget_bytes: int | None = None,
                           resume: bool = False, verbose: bool = True, *,
                           finalize: str | None = None,
                           engine: str = "fused", gate: bool = False,
                           mesh: Mesh | None = None, device) -> str:
    """Compute shard ``shard_idx`` of ``num_shards`` of the all-vs-all
    matrix on ``device`` and write its folder; returns the folder path.

    tile_rows is the square tile edge of the sweep (rounded up to a
    multiple of 128 on CUDA, :func:`sweep_tile`); tile_cols is accepted and
    ignored, as in the JAX package. With resume=True an already complete
    shard is left untouched. The shard folder is byte-identical to the JAX
    engine's on the same db.

    device_budget_bytes: the planes stay resident on the device unless
    P * Npad * d (the JAX package's rule, Npad = N rounded up to the tile)
    exceeds it; then the streaming engine runs. An integer takes that rule
    exactly, so a budget takes the same path in both packages (0 forces
    streaming). None (the default) is 0.8 x the free device memory on CUDA
    (the least of the mesh's cards: each holds a replica) and resident on
    the CPU. The JAX default of 8 GiB was half of a TPU v5e's memory; on an
    80 GB card it would stream a 2M-row db that fits.

    mesh: run mesh-parallel over its slots (devices of ``device``'s type);
    None runs on ``device`` alone.

    engine: "fused" (the default) or "two_phase" (a counts sweep, then the
    hot tiles' extraction and a separate exact finalize); tiles whose
    square is not a multiple of 32 take the two-phase engine either way,
    as in the JAX package. finalize ({None, "host", "device"}) is the
    two-phase engine's exact-dot site: "host" gathers the candidates' rows
    from the vectors memmap, "device" runs kernel X on the staged planes;
    None is "device" on CUDA and "host" on the CPU. The fused engine
    ignores it (kernel X tests its candidates' exact dots on the device),
    as in the JAX package. gate changes nothing: kernel APPEND emits nothing for an empty
    tile.
    """
    _reset_stages()
    with stage("mvs.shard.entry", LAST_STAGES, "entry_ms"):
        if finalize not in (None, "host", "device"):
            raise ValueError(f"finalize={finalize!r}: expected None, 'host' "
                             "or 'device'")
        if engine not in ("fused", "two_phase"):
            raise ValueError(f"engine={engine!r}: expected 'fused' or "
                             "'two_phase'")
        dev = resolve_device(device)
        if mesh is None:
            mesh = Mesh([dev])
        elif mesh.device_type != dev.type:
            raise ValueError(f"mesh {mesh} does not run on device "
                             f"{str(dev)!r}")
        if finalize is None:
            finalize = "device" if dev.type == "cuda" else "host"
        ops = MeshSweepOps(mesh)
        dev = mesh.lead
        shard_folder = os.path.join(output_folder, f"shard_{shard_idx}")
        if resume and shard_is_complete(output_folder, shard_idx):
            if verbose:
                log(f"Shard {shard_idx} already complete, skipping (resume)")
            return shard_folder
        tile = sweep_tile(tile_rows, dev)
        db = DbFolder(db_folder)
        d = db.dimension
        with stage("mvs.shard.norms_parse", LAST_STAGES, "norms_parse_ms"):
            norms = textparse.db_norms(db_folder)
            # float64, text round-tripped — reference :900
            norms_sq = norms * norms

        total = db.total_vectors_from_bin()
        rows_per_shard = (total + num_shards - 1) // num_shards
        begin_row = shard_idx * rows_per_shard
        end_row = min(begin_row + rows_per_shard, total)
        if verbose:
            log(f"Shard {shard_idx} processing rows {begin_row} to {end_row} "
                f"of {total} (d={d}, dtype={db.dtype}, device={dev})")

        max_abs = scan_max_abs(db)
        pm.check_exact_dot_range(d, max(1, max_abs))
        L = pm.pick_limbs(max(1, max_abs))

    if begin_row >= end_row:
        # shard beyond the row space (num_shards > N): empty-but-valid folder
        e = np.empty(0, dtype=np.int64)
        write_shard(shard_folder, e, e, e, norms_sq, d, record=LAST_STAGES)
        return shard_folder

    with stage(None, LAST_STAGES, "total_ms") as t0:
        key = _resident_key(db, total, tile, L, d, max_abs, mesh)
        held = _keep_only(key)
        budget = device_budget_bytes
        if budget is None and dev.type == "cuda":
            # a kept slot's planes count as free: the run re-uses them;
            # every card of the mesh holds one replica, so the least card
            # decides
            budget = min(int(0.8 * (torch.cuda.mem_get_info(c)[0] + held))
                         for c in mesh.distinct_devices())
        npad = (total + tile - 1) // tile * tile
        args = (db, norms_sq, total, begin_row, end_row, tile, L, d, max_abs,
                ops)
        if budget is not None and pm.num_planes(L) * npad * d > budget:
            rows, cols, vals = _compute_streaming(*args, budget, engine,
                                                  finalize)
        else:
            rows, cols, vals = _compute_device_resident(*args, key, engine,
                                                        finalize)
        if verbose:
            dt = (time.perf_counter() - t0) * 1000
            log(f"Total computation time: {dt:.0f} ms ({len(rows)} "
                "surviving pairs)")

        with stage("mvs.shard.write", LAST_STAGES, "write_ms"):
            write_shard(shard_folder, rows, cols, vals, norms_sq, d,
                        record=LAST_STAGES)
        LAST_STAGES["pairs_written"] = len(rows)
    return shard_folder


class _FileRows:
    """The (total, d) rows of vectors.bin, of its own dtype, behind one
    open file: fill(out, lo, hi) reads rows lo..hi into the host array
    ``out`` with os.preadv at their byte offset, looping on short reads.
    preadv releases the GIL, so several threads fill one buffer at once.
    A context manager: the file closes when the block ends."""

    def __init__(self, db, total, d):
        self.path = os.path.join(db.path, "vectors.bin")
        self.dtype = _vector_dtype(db)
        self.d = d
        self.row_bytes = d * self.dtype.itemsize
        self.fd = os.open(self.path, os.O_RDONLY)
        size = os.fstat(self.fd).st_size
        if size < total * self.row_bytes:
            os.close(self.fd)
            raise ValueError(f"{self.path} holds {size} bytes: fewer than "
                             f"{total} rows of {self.row_bytes}")

    def fill(self, out, lo, hi):
        view = memoryview(out).cast("B")
        pos, done = lo * self.row_bytes, 0
        while done < len(view):
            got = os.preadv(self.fd, [view[done:]], pos + done)
            if got <= 0:
                raise ValueError(f"{self.path} ends at byte {pos + done}, "
                                 f"before row {hi}")
            done += got

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        os.close(self.fd)


def _timed_fill(rows, out, lo, hi):
    t0 = time.perf_counter()
    rows.fill(out, lo, hi)
    return t0, time.perf_counter()


def _upload_rows(planes, rows, lo, hi, L, max_abs, db, dev) -> np.ndarray:
    """Write rows lo..hi of ``rows`` (:class:`_FileRows`) into the (P, *,
    d_pad) int8 planes from their row 0, one STAGE_CHUNK_BYTES chunk at a
    time, through a pipeline: STAGE_READERS threads fill the next of
    STAGE_RING host buffers (page-locked on CUDA) while the last chunk is
    copied to one of two device buffers on a copy stream and split into
    limbs on the current stream, which then sums each written row's
    squares plane by plane (:func:`~..ops.pairwise.plane_energies`). A
    host buffer is refilled once its copy's event has completed, a device
    buffer once the decomposition that read it has; the one host sync is
    the stale-max_component check at the end (each chunk's min and max,
    and the energies, stay on the device until then). On the CPU the same
    loop runs without streams. The one stager of every engine: it adds the
    fills' wall, summed over the chunks, to stage_read_ms and the rows'
    bytes to stage_bytes. -> the rows' (P, hi - lo) int64 plane energies,
    on the host (:func:`_thresholds` reads them)."""
    n, d = hi - lo, rows.d
    P = planes.shape[0]
    if n == 0:
        return np.zeros((P, 0), dtype=np.int64)
    chunk = min(n, max(1, STAGE_CHUNK_BYTES // rows.row_bytes))
    starts = range(0, n, chunk)
    cuda = dev.type == "cuda"
    dt = torch.int16 if rows.dtype == np.int16 else torch.int32
    ring = [torch.empty((chunk, d), dtype=dt, pin_memory=cuda)
            for _ in range(min(STAGE_RING, len(starts)))]
    bufs = [torch.empty((chunk, d), dtype=dt, device=dev)
            for _ in range(min(2, len(starts)))]
    if cuda:
        copies = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)
        for b in bufs:
            b.record_stream(copies)
        h2d = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
               for _ in starts]
        dec = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
               for _ in starts]
    walls: dict = {}
    fill_ms = 0.0
    bounds = []
    energies = torch.empty((P, n), dtype=torch.int64, device=dev)
    with ThreadPoolExecutor(STAGE_READERS) as pool:
        def read(k):
            """Fill host buffer k % STAGE_RING with chunk k, in parts."""
            m = min(chunk, n - starts[k])
            out = ring[k % len(ring)][:m].numpy()
            cuts = [m * i // min(STAGE_READERS, m)
                    for i in range(min(STAGE_READERS, m) + 1)]
            first = lo + starts[k]
            return [pool.submit(_timed_fill, rows, out[a:b], first + a,
                                first + b)
                    for a, b in zip(cuts, cuts[1:])]

        pending = read(0)
        for k, s in enumerate(starts):
            m = min(chunk, n - s)
            with stage("mvs.shard.stage_wait", LAST_STAGES, "stage_wait_ms"):
                spans = [f.result() for f in pending]
                if cuda and len(ring) <= k + 1 < len(starts):
                    h2d[k + 1 - len(ring)][1].synchronize()
            fill_ms += 1e3 * (max(t[1] for t in spans)
                              - min(t[0] for t in spans))
            if k + 1 < len(starts):
                pending = read(k + 1)
            host, buf = ring[k % len(ring)][:m], bufs[k % 2][:m]
            with stage("mvs.shard.stage_h2d", walls, "stage_h2d_ms"):
                if cuda:
                    if k >= 2:
                        copies.wait_event(dec[k - 2][1])
                    h2d[k][0].record(copies)
                    with torch.cuda.stream(copies):
                        buf.copy_(host, non_blocking=True)
                    h2d[k][1].record(copies)
                else:
                    buf.copy_(host)
            with stage("mvs.shard.decompose", walls, "stage_decompose_ms"):
                if cuda:
                    compute.wait_event(h2d[k][1])
                    dec[k][0].record(compute)
                v = buf.to(torch.int32)
                bounds.append(torch.stack(torch.aminmax(v)))
                pw.planes_update(planes, pw.decompose_limbs(v, L), s)
                del v
                energies[:, s:s + m] = pw.plane_energies(planes[:, s:s + m])
                if cuda:
                    dec[k][1].record(compute)
    host = torch.empty((P, n), dtype=torch.int64, pin_memory=cuda)
    host.copy_(energies, non_blocking=cuda)
    mins, maxs = torch.stack(bounds).T.tolist()
    worst = max(max(maxs), -min(mins))
    if worst > max_abs:
        raise ValueError(
            f"max_component.txt ({max_abs}) is stale: vectors.bin holds "
            f"|component| up to {worst}. Delete "
            f"{os.path.join(db.path, 'max_component.txt')} or rebuild the "
            "db folder.")
    if cuda:
        walls = {"stage_h2d_ms": sum(a.elapsed_time(b) for a, b in h2d),
                 "stage_decompose_ms": sum(a.elapsed_time(b)
                                           for a, b in dec)}
    walls.update(stage_read_ms=fill_ms, stage_bytes=n * rows.row_bytes)
    for key, val in walls.items():
        LAST_STAGES[key] += val
    return host.numpy()


def _vector_dtype(db) -> np.dtype:
    return np.dtype(np.int16 if db.dtype == "int16" else np.int32)


def _host_vectors(finalize, db, total, d):
    """The host finalize's rows: vectors.bin as a read-only (total, d)
    memmap of its own dtype for ``finalize="host"``, else None."""
    if finalize != "host":
        return None
    return np.memmap(os.path.join(db.path, "vectors.bin"),
                     dtype=_vector_dtype(db), mode="r", shape=(total, d))


def _plane_error_weights(L: int) -> np.ndarray:
    """(P,) float64 kappa_p: the float32 plane combine of kernels COUNT and
    APPEND errs by at most sum_p kappa_p |S_p| (:func:`_thresholds`), with
    kappa_p = gamma(r_p) |w_p| + |w_p - W_p|: r_p the roundings plane p's
    term goes through (its int32 -> float32 conversion, its product with
    w_p unless |w_p| is a power of two, and its P - 1 (p = 0) or P - p
    additions), gamma(r) = r u / (1 - r u), u = 2^-24, and |w_p - W_p| the
    float32 weight's distance from the exact one (nonzero from L = 5)."""
    w, exact = pm.plane_weights(L), pm.plane_weights_int(L)
    P, u = len(w), 2.0 ** -24
    kappa = np.empty(P)
    for p in range(P):
        aw = abs(float(w[p]))
        rounds = (1 + (math.frexp(aw)[0] != 0.5)
                  + (P - 1 if p == 0 else P - p))
        kappa[p] = (rounds * u / (1 - rounds * u) * aw
                    + abs(int(w[p]) - int(exact[p])))
    return kappa


def _thresholds(norms_sq, energies, L, d):
    """-> (the rows' float32 sweep thresholds, their largest slack sigma_i)
    from their squared norms n_i and their (P, rows) plane energies E_p(i)
    (:func:`_upload_rows`):

        t_i = f32(n_i + 10 A - 20 lam sigma_i),
        sigma_i = sum_p kappa_p E_p(i) / (2 d)     (in float64),

    A = SLACK_ABS, R = SLACK_REL, lam = SLACK_INFLATE, kappa_p of
    :func:`_plane_error_weights`. Kernels COUNT and APPEND (and the plain
    version) keep (i, j) when q > th, rounding every step to float32 (u =
    2^-24, c = f32(0.05), c20 = 20 c = 1 + 1.5e-8, R = 1 - 1.0014e-5):

        approx = f32(S_0) w_0 (+ f32(S_p) w_p, p = 1..P-1),
        q = fl(approx / d)   (kPow2: fl(approx * (1/d)), the same number),
        th = fl(fl(fl(c fl(t_i + t_j)) R) - A).

    Claim: every pair the exact retention keeps passes. Write N = n_i +
    n_j >= 0, D the exact dot, s = sigma_i + sigma_j.

    1. Exact side. int32: Q = trunc(D / d) with f64(Q) > T64 = f64(0.05
       f64(N)) >= 0, so Q > T64 (rounding is monotone and T64 a double),
       Q >= 1, D > 0 and D/d >= Q. int16: f64(f64(D) / d) > T64, so
       f64(D) > d T64 and D > d T64 / (1 + 2^-53). As T64 >= 0.05 N (1 -
       2^-53)^3, both give D/d > B0 = 0.05 N (1 - 2^-51).
    2. Combine. S_p, the plane's exact int32 dot, obeys |S_p| <= |a_p| |b_p|
       <= (E_p(i) + E_p(j)) / 2 (Cauchy-Schwarz, AM-GM), and the weights
       W_p of :func:`~..ops.pairwise_math.plane_weights_int` give D = sum_p
       W_p S_p; r_p roundings of relative size <= u each leave |approx -
       sum_p w_p S_p| <= sum_p gamma(r_p) |w_p| |S_p|. So |approx - D| <=
       sum_p kappa_p |S_p| <= d s.
    3. Quotient. approx is a sum of integers, so X = approx / d is 0 or at
       least 1/d away from it (no underflow) and q >= X - u|X|, which rises
       with X. X > B = B0 - s, so q > B - u|B| >= 0.05 N (1 - 2^-51 - u) -
       s (1 + u).
    4. Threshold. x_i = n_i + 10 A - 20 lam sigma_i is evaluated in float64
       within 2^-50 (n_i + 10 A + 20 lam sigma_i) and rounded once, so with
       u' = u (1 + 2^-25), Y = N + 20 A + 20 lam s and E = (1 + u)^4 (1 +
       u') - 1 < 5.0001 u, bounding t_i + t_j, its sum, the product by c,
       by R and the difference with A one rounding at a time (an
       underflow errs by 2^-150 at most, inside the A margin below) gives
         th <= R c (N + 20 A - 20 lam s) - A + u A + R c Y E
            = R c N (1 + E) - A (1 - R c20 (1 + E) - u)
              - R c20 lam s (1 - E).
    5. Compare term by term with step 3's bound:
       N: R c (1 + E) = 0.05 (1 - 9.7e-6) <= 0.05 (1 - 2^-51 - u);
       A: 1 - R c20 (1 + E) - u = 9.6e-6 > 0, a margin of 1.5e-4 on th;
       s: R c20 lam (1 - E) (1 - 2^-40) = 1 + 4.9e-6 >= 1 + u, where
          1 - 2^-40 bounds the float64 rounding of kappa_p and sigma_i.
       So th < q.  QED

    The absolute floor this needs is 0, in place of threshold_adjust's
    1.0: the 10 A a row carries, taken back by the kernels' - A after the
    product by R, leaves the margin A (1 - R c20) ~ 1.6e-4 that covers the
    absolute roundings, and SLACK_REL's 1e-5 of 0.05 N the relative ones.
    The rounding counts give lam sum_p kappa_p m_p^2 <= (P + 1) u sum_p
    |w_p| m_p^2 + sum_p |w_p - W_p| m_p^2 for every plane bound m_p a db
    can have (its largest component's: E_p(i) <= d m_p^2), so 2 lam
    sigma_i <= required_slack_abs(L, max_abs, d) <= the slack the JAX
    engine's threshold_adjust leaves: its t_i is never above ours, and its
    candidates hold ours."""
    sigma = _plane_error_weights(L) @ energies.astype(np.float64) / (2.0 * d)
    x = norms_sq + (10.0 * float(pm.SLACK_ABS) - 20.0 * SLACK_INFLATE * sigma)
    return x.astype(np.float32), float(sigma.max(initial=0.0))


def _stage_database(db, norms_sq, total, tile, L, d, max_abs, ops, key):
    """-> (per-slot (P, Npad, d_pad) int8 planes, per-slot (Npad,) float32
    thresholds), replicas on the mesh's slots, from the residency slot when
    it holds ``key`` (the stale-max check ran when it was filled, and the
    key holds max_abs and the files' mtimes), else staged on the lead
    device, replicated and kept in the slot (``value``: the lead device's
    (planes, thr); ``replicas``: the slots'; ``slack_max``). The rows are
    read from vectors.bin afresh (:class:`_FileRows`, :func:`_upload_rows`)
    and their thresholds built from their plane energies
    (:func:`_thresholds`). Peak device memory is the planes plus two
    chunks on the lead card, the planes on the others."""
    if _RESIDENT.get("key") == key:
        LAST_STAGES["slack_max"] = _RESIDENT["slack_max"]
        return _RESIDENT["replicas"]
    dev = ops.mesh.lead
    npad = (total + tile - 1) // tile * tile
    planes = torch.zeros((pm.num_planes(L), npad, pw.pad_dim(d)),
                         dtype=torch.int8, device=dev)
    with _FileRows(db, total, d) as rows:
        energies = _upload_rows(planes, rows, 0, total, L, max_abs, db, dev)
    thr = np.full(npad, np.float32(1e30), dtype=np.float32)
    thr[:total], slack = _thresholds(norms_sq, energies, L, d)
    LAST_STAGES["slack_max"] = slack
    value = (planes, torch.from_numpy(thr).to(dev))
    _RESIDENT.clear()
    _RESIDENT.update(key=key, value=value, replicas=ops.replicate(*value),
                     slack_max=slack)
    return _RESIDENT["replicas"]


def _make_finalizer(norms_sq, begin_row, end_row, total, d, dtype):
    """-> (parts, finalize_globals(r, c, exact_dots)): the two-phase
    engine's exact retention on the host (JAX ``:914-931``) of candidate
    pairs without dots: the range filter first, then exact_dots(rows,
    cols) of the pairs kept (:func:`_exact_dots`) and the reference's test
    of the db's ``dtype``, timed under finalize_ms; survivors are appended
    to parts as (rows, cols, dots). Every pair counts under candidates and
    emitted, the dropped ones too."""
    parts: list = []
    exact_filter = pm.exact_filter_int16 if dtype == "int16" \
        else pm.exact_filter_int32

    def finalize_dots(r_glob, c_glob, dots):
        with stage("mvs.shard.finalize", LAST_STAGES, "finalize_ms"):
            LAST_STAGES["candidates"] += len(r_glob)
            keep_range = ((r_glob >= begin_row) & (r_glob < end_row)
                          & (c_glob < total))
            if not keep_range.all():
                r_glob, c_glob = r_glob[keep_range], c_glob[keep_range]
                dots = dots[keep_range]
            LAST_STAGES["emitted"] += len(r_glob)
            if len(r_glob):
                thr_exact = 0.05 * (norms_sq[r_glob] + norms_sq[c_glob])
                keep = exact_filter(dots, thr_exact, d)
                if keep.any():
                    parts.append((r_glob[keep], c_glob[keep], dots[keep]))

    def finalize_globals(r_glob, c_glob, exact_dots):
        with stage("mvs.shard.finalize", LAST_STAGES, "finalize_ms"):
            keep_range = ((r_glob >= begin_row) & (r_glob < end_row)
                          & (c_glob < total))
            kept_r, kept_c = r_glob[keep_range], c_glob[keep_range]
            dropped = len(r_glob) - len(kept_r)
            LAST_STAGES["candidates"] += dropped
            LAST_STAGES["emitted"] += dropped
            if len(kept_r) == 0:
                return
            dots = exact_dots(kept_r, kept_c)
        finalize_dots(kept_r, kept_c, dots)

    return parts, finalize_globals


def _exact_dots(finalize, V, max_abs, L, planes_i, row_base=0,
                planes_j=None, col_base=0):
    """-> exact_dots(rows, cols): exact int64 dots of candidate pairs given
    by global rows and columns (JAX ``exact_dots``, ``:905-912``). "host"
    gathers them from the vectors memmap V (pairwise_math.exact_dots_host);
    "device" runs kernel X on the staged planes (planes_i holds the global
    rows row_base.., planes_j, planes_i when None, col_base..;
    ops.pairwise.exact_dots_device)."""
    if finalize == "host":
        return lambda r, c: pm.exact_dots_host(V, r, c, max_abs)
    return lambda r, c: pw.exact_dots_device(planes_i, L, r - row_base,
                                             c - col_base, planes_j)


def _retentions(ops, norms_sq, dtype, d, begin_row, end_row, total):
    """-> per slot the shard's :class:`~..ops.pairwise.Retention`, the
    squared norms staged once a call on the lead card (8 B a row) and
    replicated."""
    ns = torch.from_numpy(np.ascontiguousarray(norms_sq, dtype=np.float64))
    slots = ops.replicate(ns.to(ops.mesh.lead))
    return [pw.Retention(n, d, dtype == "int16", begin_row, end_row, total)
            for n in slots]


def _keep(ops, planes_i, swept, L, keeps, cap, parts, planes_j=None,
          row_base=0, col_base=0, twins=None) -> int:
    """Kernel X's retention (:meth:`MeshSweepOps.pair_keep`) of the per-slot
    survivors ``swept`` under extract_ms; the kept pairs appended to parts
    and the counters added under finalize_ms -> the largest kept count of
    a slot."""
    with stage("mvs.shard.extract", LAST_STAGES, "extract_ms"):
        kept, emitted, nbytes = ops.pair_keep(planes_i, swept, L, keeps, cap,
                                              planes_j, row_base, col_base,
                                              twins)
    with stage("mvs.shard.finalize", LAST_STAGES, "finalize_ms"):
        LAST_STAGES["candidates"] += sum(run[1] for run in swept
                                         if run is not None)
        LAST_STAGES["emitted"] += emitted
        LAST_STAGES["readback_bytes"] += nbytes
        # a slot that kept more than cap ran kernel X again at its count
        LAST_STAGES["keep_reruns"] += sum(k is not None and len(k[0]) > cap
                                          for k in kept)
        parts.extend(k for k in kept if k is not None and len(k[0]))
    return max((len(k[0]) for k in kept if k is not None), default=0)


def _self_pairs(ops, planes, lo, hi, row_base, L, keeps, parts):
    """Self-pairs of the planes' rows [lo, hi) (global rows row_base + lo
    ..): masked out of the sweep (diagonal tiles keep ordinary density) and
    tested from their exact self dots through kernel X, on the first slot
    (O(N) work); the reference keeps them
    (pairwise_comp_optimized.cpp:659)."""
    local = torch.arange(lo, hi, dtype=torch.int32, device=ops.mesh.lead)
    rc = torch.stack([local, local], 1).contiguous()
    swept = [(rc, hi - lo)] + [None] * (ops.n_devices - 1)
    _keep(ops, planes, swept, L, keeps, hi - lo, parts, row_base=row_base,
          col_base=row_base)


def _compute_device_resident(db, norms_sq, total, begin_row, end_row, tile,
                             L, d, max_abs, ops, key, engine, finalize):
    """The resident engines' router (JAX ``:391-401``): fused when asked
    for and tile^2 % 32 == 0 (the JAX fused engine packs 32-bit mask words;
    a CUDA tile, a multiple of 128, always qualifies), else two-phase."""
    args = (db, norms_sq, total, begin_row, end_row, tile, L, d, max_abs,
            ops, key)
    if engine == "fused" and tile * tile % 32 == 0:
        return _compute_device_resident_fused(*args)
    return _compute_device_resident_two_phase(*args, finalize)


def _compute_device_resident_fused(db, norms_sq, total, begin_row, end_row,
                                   tile, L, d, max_abs, ops, key):
    with stage("mvs.shard.stage", LAST_STAGES, "stage_ms"):
        planes, thr = _stage_database(db, norms_sq, total, tile, L, d,
                                      max_abs, ops, key)
        keeps = _retentions(ops, norms_sq, db.dtype, d, begin_row, end_row,
                            total)
        _sync(ops.mesh.lead)
    LAST_STAGES["mode"] = "fused"

    nt = planes[0].shape[1] // tile
    rt0, rt1 = begin_row // tile, (end_row - 1) // tile + 1
    # TRIANGLE tile grid: inside the shard's row-tile range [rt0, rt1) tiles
    # (r, c) and (c, r) carry the same unordered pairs and every per-pair
    # quantity is symmetric, so only c >= r is swept and kernel X emits each
    # off-diagonal survivor in both directions (twins). Column tiles
    # outside the range keep the full rectangle (their mirror rows belong
    # to other shards); diagonal tiles already carry both orders.
    coords = np.array([(r, c) for r in range(rt0, rt1) for c in range(nt)
                       if c >= r or not rt0 <= c < rt1],
                      dtype=np.int32).reshape(-1, 2)

    parts: list = []
    _self_pairs(ops, planes, begin_row, end_row, 0, L, keeps, parts)
    _sweep(ops, planes, thr, planes, thr, tile, L, d, coords, keeps, parts,
           twins=(tile, rt0, rt1))
    return _concat(parts)


def _compute_streaming(db, norms_sq, total, begin_row, end_row, tile, L, d,
                       max_abs, ops, budget, engine, finalize):
    """The streaming engines' router (JAX ``:1098-1104``), as
    :func:`_compute_device_resident`'s."""
    args = (db, norms_sq, total, begin_row, end_row, tile, L, d, max_abs,
            ops, budget)
    if engine == "fused" and tile * tile % 32 == 0:
        return _compute_streaming_fused(*args)
    return _compute_streaming_two_phase(*args, finalize)


def _stage_block(rows, norms_sq, start, end, n_rows, L, max_abs, db, ops):
    """Rows start..end of ``rows`` (:class:`_FileRows`) -> per-slot
    replicas of their (P, n_rows, d_pad) int8 planes and (n_rows,) float32
    thresholds (1e30 on the pad rows past the block): the streaming
    engines' staging of a block through :func:`_upload_rows`, on the lead
    device, the thresholds from the block's own plane energies
    (:func:`_thresholds`; slack_max keeps the largest of the call's
    blocks)."""
    dev = ops.mesh.lead
    planes = torch.zeros((pm.num_planes(L), n_rows, pw.pad_dim(rows.d)),
                         dtype=torch.int8, device=dev)
    energies = _upload_rows(planes, rows, start, end, L, max_abs, db, dev)
    thr = np.full(n_rows, np.float32(1e30), dtype=np.float32)
    thr[:end - start], slack = _thresholds(norms_sq[start:end], energies, L,
                                           rows.d)
    LAST_STAGES["slack_max"] = max(LAST_STAGES["slack_max"], slack)
    return ops.replicate(planes, torch.from_numpy(thr).to(dev))


def _compute_streaming_fused(db, norms_sq, total, begin_row, end_row, tile,
                             L, d, max_abs, ops, budget):
    """The beyond-memory engine (JAX ``_compute_streaming_fused``, with its
    schedule): a ROW GROUP of the shard's row tiles is staged once and a
    WINDOW of column tiles at a time streams past it; kernel APPEND sweeps
    every (row tile x window tile) of the full rectangle with two operands,
    and masks the self-pairs through its diagonal offset (window start -
    row group start). The budget is split in quarters: the row group, the
    window being swept, the next window and staging temporaries. Every
    block is read from vectors.bin, opened once a call, by the one stager.
    On a mesh the row group and the window are staged on the lead device
    and replicated to the slots (JAX ``compute.py:1167-1259``)."""
    LAST_STAGES["mode"] = "fused-streaming"
    P = pm.num_planes(L)
    parts: list = []
    with stage("mvs.shard.stage", LAST_STAGES, "stage_ms"):
        keeps = _retentions(ops, norms_sq, db.dtype, d, begin_row, end_row,
                            total)

    bytes_per_tile = P * tile * d
    share = max(budget // 4, 2 * bytes_per_tile)
    rg_tiles = max(1, min((end_row - begin_row + tile - 1) // tile,
                          share // bytes_per_tile))
    window_tiles = max(1, share // bytes_per_tile)
    windows = range(0, total, window_tiles * tile)
    row_groups = range(begin_row, end_row, rg_tiles * tile)
    LAST_STAGES.update(row_groups=len(row_groups), windows=len(windows),
                       tiles_swept=0)

    with _FileRows(db, total, d) as rows:
        for rg in row_groups:
            rg_end = min(rg + rg_tiles * tile, end_row)
            n_r = (rg_end - rg + tile - 1) // tile
            with stage("mvs.shard.stage", LAST_STAGES, "stage_ms"):
                planes_r = thr_r = None           # free the last group first
                planes_r, thr_r = _stage_block(rows, norms_sq, rg, rg_end,
                                               n_r * tile, L, max_abs, db,
                                               ops)
            _self_pairs(ops, planes_r, 0, rg_end - rg, rg, L, keeps, parts)
            for ws in windows:
                we = min(ws + window_tiles * tile, total)
                n_w = (we - ws + tile - 1) // tile
                with stage("mvs.shard.stage", LAST_STAGES, "stage_ms"):
                    planes_w = thr_w = None       # free the last window first
                    planes_w, thr_w = _stage_block(rows, norms_sq, ws, we,
                                                   n_w * tile, L, max_abs,
                                                   db, ops)
                coords = np.array([(ri, wj) for ri in range(n_r)
                                   for wj in range(n_w)], dtype=np.int32)
                LAST_STAGES["tiles_swept"] += len(coords)
                _sweep(ops, planes_r, thr_r, planes_w, thr_w, tile, L, d,
                       coords, keeps, parts, row_base=rg, col_base=ws)
    return _concat(parts)


def _sweep(ops, planes_i, thr_i, planes_j, thr_j, tile, L, d, coords, keeps,
           parts, row_base=0, col_base=0, twins=None):
    """Kernel APPEND over ``coords`` (row tiles of planes_i x column tiles
    of planes_j, per-slot replicas whose first rows are the global rows
    row_base and col_base): the tiles are split once into per-slot tile
    lists on the cards (:meth:`MeshSweepOps.tile_lists`), and round by
    round every slot sweeps the next range of its own list, then kernel X
    tests each slot's survivors on its card (:func:`_keep`; ``keeps``, the
    per-slot retention, ``twins`` the resident triangle's mirror) and the
    kept pairs are appended to parts, slot by slot."""
    lists = ops.tile_lists(coords)
    per_slot = max((len(t) for t in lists if t is not None), default=0)
    # the survivors' rc bytes: kernel X's kept-pair buffer adds 1/KEEP_SHARE
    # of a record a pair
    per_pair = 8
    # kernel APPEND counts in 32 bits: one slot's range holds fewer than
    # 2^31 pairs
    chunk = max(1, min(per_slot, (2**31 - 1) // (tile * tile)))
    cap = SWEEP_CAP_START
    keep_cap = KEEP_CAP_START
    diag = col_base - row_base
    s = 0
    while s < per_slot:
        e = min(s + chunk, per_slot)
        with stage("mvs.shard.sweep", LAST_STAGES, "sweep_ms"):
            res = ops.sweep_extract_fused(planes_i, thr_i, lists, tile, cap,
                                          d,
                                          CANDIDATE_BUDGET_BYTES // per_pair,
                                          planes_j, thr_j, diag, first=s,
                                          count=e - s)
            if res is not None:
                # a slot past cap swept its range again at its total; the
                # next round's capacity: this round's largest slot total
                LAST_STAGES["sweep_reruns"] += sum(
                    run is not None and run[1] > cap for run in res[0])
                cap = max([cap] + [run[1] for run in res[0]
                                   if run is not None])
        if res is None:
            # a slot's exact buffer would break the budget: fewer tiles a
            # slot, same start
            chunk = max(1, (e - s) // 2)
            continue
        most = max([0] + [run[1] for run in res[0] if run is not None])
        keep_cap = max(keep_cap, _keep(
            ops, planes_i, res[0], L, keeps,
            max(keep_cap, most // KEEP_SHARE), parts, planes_j, row_base,
            col_base, twins))
        s = e


def _compute_device_resident_two_phase(db, norms_sq, total, begin_row,
                                       end_row, tile, L, d, max_abs, ops, key,
                                       finalize):
    """The two-phase engine on the resident planes (JAX ``:788-867``): the
    residency slot's planes (shared with the fused engine: a fused and a
    two-phase shard of one db stage once), the counts sweep over the FULL
    rectangle of the shard's row tiles x every column tile (kernel COUNT),
    then :func:`_extract_tiles` with the finalize's exact dots."""
    with stage("mvs.shard.stage", LAST_STAGES, "stage_ms"):
        planes, thr = _stage_database(db, norms_sq, total, tile, L, d,
                                      max_abs, ops, key)
        _sync(ops.mesh.lead)
    LAST_STAGES.update(mode="two_phase", reruns=0, hot_tiles=0)

    nt = planes[0].shape[1] // tile
    rt0, rt1 = begin_row // tile, (end_row - 1) // tile + 1
    coords = np.array([(r, c) for r in range(rt0, rt1) for c in range(nt)],
                      dtype=np.int32).reshape(-1, 2)
    with stage("mvs.shard.sweep", LAST_STAGES, "sweep_ms"):
        counts = ops.sweep_counts(planes, thr, ops.tile_lists(coords), tile,
                                  d)

    exact = _exact_dots(finalize, _host_vectors(finalize, db, total, d),
                        max_abs, L, planes[0])
    parts, finalize_globals = _make_finalizer(norms_sq, begin_row, end_row,
                                              total, d, db.dtype)
    _extract_tiles(ops, planes, thr, planes, thr, tile, L, d, coords, counts,
                   0, 0, lambda r, c: finalize_globals(r, c, exact))
    return _concat(parts)


def _compute_streaming_two_phase(db, norms_sq, total, begin_row, end_row,
                                 tile, L, d, max_abs, ops, budget,
                                 finalize):
    """The two-phase engine beyond the device budget (JAX ``:1214-1273``):
    windows of column tiles on the outer loop, each staged once per shard
    (a third of the budget, JAX's rule), and one row tile of the shard at a
    time on the inner loop (staged under sweep_ms, as in JAX), each read
    from vectors.bin, opened once a call, by the one stager. Kernels
    APPEND and COUNT take the row tile and the window as their two
    operands (the window's tile list goes to the card once), not
    concatenated: the survivors come back operand-local and the row tile's
    and the window's first global rows place them, self-pairs included
    (they are kept, so no diagonal offset masks anything). Then the
    resident engine's extraction and finalize ("device": kernel X on the
    two operands)."""
    LAST_STAGES.update(mode="two_phase-streaming", reruns=0, hot_tiles=0)
    V = _host_vectors(finalize, db, total, d)
    P = pm.num_planes(L)
    bytes_per_tile = P * tile * d
    window_tiles = max(1, int(max(budget // 3, 2 * bytes_per_tile)
                              // bytes_per_tile) - 1)
    parts, finalize_globals = _make_finalizer(norms_sq, begin_row, end_row,
                                              total, d, db.dtype)
    windows = range(0, total, window_tiles * tile)
    LAST_STAGES["windows"] = len(windows)
    with _FileRows(db, total, d) as rows:
        for ws in windows:
            we = min(ws + window_tiles * tile, total)
            n_w = (we - ws + tile - 1) // tile
            with stage("mvs.shard.stage", LAST_STAGES, "stage_ms"):
                planes_w, thr_w = _stage_block(rows, norms_sq, ws, we,
                                               n_w * tile, L, max_abs, db,
                                               ops)
            coords = np.array([(0, j) for j in range(n_w)], dtype=np.int32)
            lists = ops.tile_lists(coords)
            for bi in range(begin_row, end_row, tile):
                with stage("mvs.shard.sweep", LAST_STAGES, "sweep_ms"):
                    planes_r = thr_r = None   # free the last row tile first
                    planes_r, thr_r = _stage_block(
                        rows, norms_sq, bi, min(bi + tile, end_row), tile, L,
                        max_abs, db, ops)
                    counts = ops.sweep_counts(planes_r, thr_r, lists, tile,
                                              d, planes_w, thr_w)
                exact = _exact_dots(finalize, V, max_abs, L, planes_r[0], bi,
                                    planes_w[0], ws)
                _extract_tiles(ops, planes_r, thr_r, planes_w, thr_w, tile,
                               L, d, coords, counts, bi, ws,
                               lambda r, c: finalize_globals(r, c, exact))
            planes_w = thr_w = None           # free the last window first
    return _concat(parts)


def _extract_tiles(ops, planes_i, thr_i, planes_j, thr_j, tile, L, d, coords,
                   counts, row_base, col_base, finalize):
    """The two-phase engine's hot-tile extraction (JAX ``:936-1078``): the
    tiles ``coords`` with counts > 0, in consecutive chunks whose summed
    counts fit CANDIDATE_BUDGET_BYTES (checked before any launch; one tile
    at least), each chunk one round of kernel APPEND with the self-pairs
    kept on every slot (the chunk's per-slot tile lists go to the cards
    once), at the capacity its counts give, timed under extract_ms with
    the copy of its survivors. The survivors' operand-local (row, column)
    pairs come to the host and, placed by row_base and col_base (the global
    rows of planes_i's and planes_j's first rows), go to finalize(rows,
    cols), outside extract_ms.

    The counts are advisory, as in JAX (``:995-1000``): a slot whose
    APPEND total exceeds its capacity is rerun at the exact total
    (LAST_STAGES reruns), a chunk whose APPEND counts differ from its COUNT
    is logged, and a slot of several tiles that would break the budget
    halves the chunk. On the card COUNT and APPEND are the two epilogues of
    one kernel (csrc/count.cu) with one retention test, so neither
    happens."""
    per_pair = (2 + pm.num_planes(L)) * 4         # rc + partials bytes
    limit = CANDIDATE_BUDGET_BYTES // per_pair
    hot = np.flatnonzero(counts > 0)
    LAST_STAGES["hot_tiles"] += len(hot)
    s, take = 0, len(hot)
    while s < len(hot):
        with stage("mvs.shard.extract", LAST_STAGES, "extract_ms"):
            csum = np.cumsum(counts[hot[s:s + take]])
            e = s + max(1, int(np.searchsorted(csum, limit, side="right")))
            ks = hot[s:e]
            want = counts[ks]
            cap = ops.block_total_max(want)
            res = ops.sweep_extract_fused(planes_i, thr_i,
                                          ops.tile_lists(coords[ks]), tile,
                                          cap, d, limit, planes_j, thr_j,
                                          mask_self=False)
            if res is None:
                take = max(1, (e - s) // 2)
                continue
            swept, got = res
            del res
            LAST_STAGES["reruns"] += sum(run is not None and run[1] > cap
                                         for run in swept)
            if not np.array_equal(got, want):
                log(f"two-phase extraction: {int((got != want).sum())} of "
                    f"{len(ks)} tiles found {int(got.sum())} survivors "
                    f"where the counts sweep found {int(want.sum())}")
            hosts = ops.host_pairs(swept)
            del swept            # the candidate buffers, before the finalize
        for rc in hosts:
            if rc is not None:
                finalize(rc[:, 0].astype(np.int64) + row_base,
                         rc[:, 1].astype(np.int64) + col_base)
        s, take = e, len(hot)


def _sets_key(hashes_file: str, db_folder, dev) -> tuple:
    """The MinHash slot's key: the hashes file's path, mtime and size (and
    the db folder's norms file's, whose order it takes) and the device."""
    key = (os.path.abspath(hashes_file), os.path.getmtime(hashes_file),
           os.path.getsize(hashes_file))
    if db_folder:
        norms = os.path.join(db_folder, "vector_norms.txt")
        key += (os.path.abspath(norms), os.path.getmtime(norms),
                os.path.getsize(norms))
    return key + (str(dev),)


def stage_minhash_sets(hashes_file: str, db_folder: str | None = None, *,
                       device) -> dict:
    """The collection of ``hashes_file`` staged on ``device``
    (ops.minhash.stage_sets), in the one-slot MinHash residency cache: the
    file parsed (io.hashes.parse_hashes_file), its sets ordered as
    ``db_folder``'s vector_norms.txt when given, sorted and split on the
    device. A slot of the same file returns at once; another file's slot is
    evicted first. -> the slot: {"key", "names", "sizes" (host int64),
    "staged" (ops.minhash.Staged), "norms_text" (the minhash_db's
    vector_norms.txt; None with a db folder), "file_bytes"}."""
    dev = resolve_device(device)
    key = _sets_key(hashes_file, db_folder, dev)
    if _SETS.get("key") == key:
        return _SETS
    on_cuda = bool(_SETS) and _SETS["staged"].sizes.is_cuda
    _SETS.clear()
    if on_cuda:
        torch.cuda.empty_cache()
    named = parse_hashes_file(hashes_file)
    names = [n for n, _ in named]
    sets_ = [h for _, h in named]
    del named
    if db_folder:
        order = DbFolder(db_folder).names_and_norms()[0]
        index = {n: i for i, n in enumerate(names)}
        sets_ = [sets_[index[n]] for n in order]
        names = order
    staged = minhash.stage_sets(sets_, device=dev)
    _sync(dev)
    sizes = staged.sizes.cpu().numpy()
    # the minhash_db's norms (norm = sqrt(|set|)), formatted once
    norms_text = None if db_folder else "".join(
        f"{n} {np.sqrt(float(s)):.6g}\n" for n, s in zip(names, sizes))
    _SETS.update(key=key, names=names, staged=staged, sizes=sizes,
                 norms_text=norms_text,
                 file_bytes=os.path.getsize(hashes_file))
    return _SETS


@entry_span("minhash")
def compute_minhash_shard(hashes_file: str, output_folder: str,
                          num_shards: int = 1, shard_idx: int = 0,
                          db_folder: str | None = None,
                          verbose: bool = True, *, device) -> str:
    """MinHash-strategy pairwise shard (the reference's historical
    --strategy 1): EXACT set Jaccard from the raw hash sets, the shard's
    rows only, on ``device`` (ops.minhash: kernel G's rows over the heavy
    hashes, kernel C over the light postings, kernel M's retention test and
    compaction), written in the active matrix format. Byte-identical to the
    JAX package's shard. The sets are staged once a process
    (:func:`stage_minhash_sets`); only the kept triples leave the card.

    If db_folder is given, its vector_norms.txt order defines the indices;
    otherwise a minimal db folder 'minhash_db' is written next to the matrix
    (norm = sqrt(|set|), so norm^2 is the exact |A|), so the query stack
    works unchanged. LAST_STAGES gets the MinHash stage walls and counters
    (ops.minhash.LAST_STAGES' keys; stage_ms and stage_bytes, the file's
    bytes, are 0 on a slot hit)."""
    dev = resolve_device(device)
    LAST_STAGES.clear()
    LAST_STAGES.update(mode="minhash", stage_ms=0.0, heavy_ms=0.0,
                       light_ms=0.0, keep_ms=0.0, write_ms=0.0,
                       stage_bytes=0, pairs_written=0)
    before = _SETS.get("key")
    with stage("mvs.minhash.stage", LAST_STAGES, "stage_ms"):
        slot = stage_minhash_sets(hashes_file, db_folder, device=dev)
    if slot["key"] != before:
        LAST_STAGES["stage_bytes"] = slot["file_bytes"]
    names, sizes = slot["names"], slot["sizes"]
    total = len(names)
    rows_per_shard = (total + num_shards - 1) // num_shards
    begin_row = min(shard_idx * rows_per_shard, total)
    end_row = min(begin_row + rows_per_shard, total)
    if verbose:
        log(f"MinHash shard {shard_idx}: rows {begin_row} to {end_row} of {total}")

    t0 = time.perf_counter()
    r, c, inter = minhash.shard_triples(slot["staged"], begin_row, end_row,
                                        LAST_STAGES)
    if verbose:
        log(f"Total computation time: {(time.perf_counter()-t0)*1000:.0f} ms "
            f"({len(r)} surviving pairs)")

    shard_folder = os.path.join(output_folder, f"shard_{shard_idx}")
    with stage("mvs.minhash.write", LAST_STAGES, "write_ms"):
        if not db_folder:
            mdb = os.path.join(output_folder, "minhash_db")
            os.makedirs(mdb, exist_ok=True)
            with open(os.path.join(mdb, "vector_norms.txt"), "w") as f:
                f.write(slot["norms_text"])
            with open(os.path.join(mdb, "dimension.txt"), "w") as f:
                f.write("1\n")
            with open(os.path.join(mdb, "dtype.txt"), "w") as f:
                f.write("minhash\n")
        # dimension=1 and norms_sq=|A| make the writer's
        # J = inter/(|A|+|B|-inter) the exact set Jaccard
        write_shard(shard_folder, r, c, inter, sizes.astype(np.float64),
                    dimension=1, record=LAST_STAGES)
    LAST_STAGES["pairs_written"] = len(r)
    return shard_folder


def compute_pairwise_oracle(vectors: np.ndarray, norms_sq: np.ndarray,
                            dimension: int, dtype: str = "int32",
                            row_range: tuple[int, int] | None = None):
    """Brute-force float64/int64 numpy oracle of the reference semantics —
    used by the conformance tests (the reference pairwise binary cannot be
    built: its `bits` submodule is unpinned/empty). The JAX package's
    function, unchanged: int16 dbs keep dot / d > thr, int32 dbs compare
    the truncating int division."""
    n = vectors.shape[0]
    lo, hi = row_range if row_range else (0, n)
    v = vectors.astype(np.int64)
    rows, cols, vals = [], [], []
    for i in range(lo, hi):
        dots = v[i] @ v.T  # exact int64
        thr = 0.05 * (norms_sq[i] + norms_sq)
        if dtype == "int16":
            keep = dots.astype(np.float64) / dimension > thr
        else:
            q = np.where(dots >= 0, dots // dimension, -((-dots) // dimension))
            keep = q.astype(np.float64) > thr
        j = np.flatnonzero(keep)
        rows.append(np.full(len(j), i, dtype=np.int64))
        cols.append(j.astype(np.int64))
        vals.append(dots[j])
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals))


def _concat(parts):
    if not parts:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), e.copy()
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))
