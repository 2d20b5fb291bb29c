"""Inputs made from the seed: the db's vectors on the device, its folder in
the upstream format, and the search traffic's query files with their planted
relatives.

Vectors are the upstream accuracy study's surrogate of a projected hash set
(src/compute_error_of_random_projections.py,
``get_me_a_random_projection_like_vector``): each lane of a set of n hashes
is a sum of n independent +-1 draws, 2 * Binomial(n, 1/2) - n; above 10^4
hashes the binomial is drawn as its normal approximation, with the lane's
parity kept. Planted groups share one component: each member is the sum of
the group's shared lanes and its own private lanes.

Every seed gets the same multiset of set sizes and of planted shapes, in
another order, so that the work of a run does not depend on its seed.
"""

from __future__ import annotations

import gc
import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
EXACT_BELOW = 10_000
ROWS_A_CHUNK = 16384


def free_device():
    """Hand the device memory of dropped tensors back to the driver."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- sizes

def size_multiset(law: dict, n: int) -> np.ndarray:
    """The n set sizes of a size law, ascending and fixed (no seed):
    ``{"law": "fixture", "file": ...}`` repeats the fixture's sizes in equal
    shares; ``{"law": "log_uniform", "low": a, "high": b}`` takes n evenly
    spaced quantiles of the log-uniform law on [a, b]."""
    if law["law"] == "fixture":
        with open(os.path.join(HERE, law["file"])) as f:
            base = np.sort(np.asarray(json.load(f)["sizes"], dtype=np.int64))
        return base[(np.arange(n) * len(base)) // n]
    if law["law"] == "log_uniform":
        lo, hi = np.log(float(law["low"])), np.log(float(law["high"]))
        q = (np.arange(n) + 0.5) / n
        return np.round(np.exp(lo + q * (hi - lo))).astype(np.int64)
    raise ValueError(f"unknown size law {law['law']!r}")


def layout(cfg: dict, seed: int) -> dict:
    """Rows of the db: each row's private set size, its planted group (-1:
    none) and each group's shared size. Groups are formed from neighbouring
    sizes of the ascending multiset, a fixed share of the rows, so that
    their members are alike in size; rows are then placed by the seed."""
    n = int(cfg["num_vectors"])
    sizes = size_multiset(cfg["set_sizes"], n)
    plant = cfg["planted"]
    g = int(plant["group"])
    every = int(round(1.0 / float(plant["share_of_rows"])))
    group_of = np.full(n, -1, dtype=np.int64)
    blocks = np.arange(n // g)
    chosen = blocks[blocks % every == 0]
    shared = np.zeros(len(chosen), dtype=np.int64)
    for k, b in enumerate(chosen):
        members = np.arange(b * g, (b + 1) * g)
        size = int(sizes[members[0]])
        sizes[members] = size
        group_of[members] = k
        shared[k] = int(round(size * plant["shared"] / plant["of"]))
    private = sizes.copy()
    grouped = group_of >= 0
    private[grouped] -= shared[group_of[grouped]]
    perm = np.random.default_rng([seed, 1]).permutation(n)
    return {"sizes": sizes[perm], "private": private[perm],
            "group_of": group_of[perm], "shared": shared}


def _lanes(counts: torch.Tensor, d: int, gen: torch.Generator) -> torch.Tensor:
    """(r,) int64 hash counts -> (r, d) int64 lanes, each the sum of that
    many +-1 draws."""
    dev = counts.device
    out = torch.empty((len(counts), d), dtype=torch.int64, device=dev)
    small = counts <= EXACT_BELOW
    if bool(small.any()):
        c = counts[small].to(torch.float32)[:, None].expand(-1, d)
        b = torch.binomial(c.contiguous(), torch.full_like(c, 0.5),
                           generator=gen)
        out[small] = 2 * b.to(torch.int64) - counts[small][:, None]
    if bool((~small).any()):
        c = counts[~small].to(torch.float64)[:, None]
        z = torch.randn((len(c), d), dtype=torch.float64, device=dev,
                        generator=gen)
        k = torch.round((c + c.sqrt() * z) / 2).clamp_(min=0)
        k = torch.minimum(k, c.expand(-1, d))
        out[~small] = 2 * k.to(torch.int64) - counts[~small][:, None]
    return out


def make_vectors(cfg: dict, seed: int, device) -> tuple[torch.Tensor, dict]:
    """-> ((N, d) int32 vectors on ``device``, the layout), with the
    largest component pinned (:func:`pin_max`)."""
    dev = torch.device(device)
    lay = layout(cfg, seed)
    n, d = int(cfg["num_vectors"]), int(cfg["dimension"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    shared = _lanes(torch.from_numpy(lay["shared"]).to(dev), d, gen)
    V = torch.empty((n, d), dtype=torch.int32, device=dev)
    private = torch.from_numpy(lay["private"]).to(dev)
    group_of = torch.from_numpy(lay["group_of"]).to(dev)
    for s in range(0, n, ROWS_A_CHUNK):
        e = min(s + ROWS_A_CHUNK, n)
        block = _lanes(private[s:e], d, gen)
        g = group_of[s:e]
        mine = torch.nonzero(g >= 0).flatten()
        block[mine] += shared[g[mine]]
        V[s:e] = block.to(torch.int32)
    del shared
    pin_max(V, lay, cfg)
    return V, lay


def pin_max(V: torch.Tensor, lay: dict, cfg: dict) -> None:
    """Cap every component at the configuration's ``max_component`` (for an
    int16 db at most the int16 range, as the upstream ``sketch --int16``
    caps it) and set lane 0 of the first row of the largest set to it: the
    db's largest component, and with it the program's limbs and the
    certified slack of its sweep, is then the same for every seed."""
    M = int(cfg["max_component"])
    if cfg["dtype"] == "int16":
        M = min(M, 32767)
    V.clamp_(-M, M)
    V[int(np.argmax(lay["sizes"])), 0] = M


# ---------------------------------------------------------------- db folder

def write_db(path: str, V: torch.Tensor, dtype: str) -> dict:
    """Write the upstream db folder (vectors.bin, vector_norms.txt,
    dimension.txt, dtype.txt) plus the max_component.txt that the port's
    ingest writes, last, so that it is never older than vectors.bin.
    -> {"names", "norms_text"} of what was written."""
    os.makedirs(path, exist_ok=True)
    n, d = V.shape
    names = [f"ACC{i:07d}" for i in range(n)]
    host_dt = np.int16 if dtype == "int16" else np.int32
    norms = np.empty(n, dtype=np.float32)
    max_abs = 0
    with open(os.path.join(path, "vectors.bin"), "wb") as f:
        for s in range(0, n, ROWS_A_CHUNK):
            blk = V[s:s + ROWS_A_CHUNK]
            if dtype == "int16":
                blk = blk.clamp(-32768, 32767)
            f64 = blk.to(torch.float64)
            norms[s:s + len(blk)] = (f64.square().sum(1).sqrt()
                                     / np.sqrt(d)).to(torch.float32).cpu().numpy()
            max_abs = max(max_abs, int(blk.abs().max()))
            blk.cpu().numpy().astype(host_dt).tofile(f)
    text = "".join(f"{nm} {x:.6g}\n" for nm, x in zip(names, norms.tolist()))
    with open(os.path.join(path, "vector_norms.txt"), "w") as f:
        f.write(text)
    with open(os.path.join(path, "dimension.txt"), "w") as f:
        f.write(f"{d}\n")
    with open(os.path.join(path, "dtype.txt"), "w") as f:
        f.write(f"{dtype}\n")
    with open(os.path.join(path, "max_component.txt"), "w") as f:
        f.write(f"{max_abs}\n")
    return {"names": names, "max_abs": max_abs}


def read_db(path: str, device) -> dict:
    """The written db as the reference reads it: (N, d) int32 vectors on
    ``device``, names and the squared text norms (float64)."""
    with open(os.path.join(path, "dimension.txt")) as f:
        d = int(f.read())
    with open(os.path.join(path, "dtype.txt")) as f:
        dtype = f.read().strip()
    names, norms = [], []
    with open(os.path.join(path, "vector_norms.txt")) as f:
        for line in f:
            a, b = line.split()
            names.append(a)
            norms.append(float(b))
    raw = np.fromfile(os.path.join(path, "vectors.bin"),
                      dtype=np.int16 if dtype == "int16" else np.int32)
    V = torch.from_numpy(raw.reshape(-1, d)).to(device).to(torch.int32)
    norms = np.asarray(norms, dtype=np.float64)
    return {"V": V, "d": d, "dtype": dtype, "names": names, "norms": norms,
            "ns": norms * norms}


# ---------------------------------------------------------------- queries

def query_pool(cfg: dict, traffic: dict, seed: int) -> dict:
    """The search traffic's query accessions: sizes from the configuration's
    law (a fixed multiset), dealt to the files in strata so that every file
    carries alike work; which queries have relatives, how many and at which
    Jaccard, from fixed multisets in the seed's order."""
    files, per = int(traffic["files"]), int(traffic["queries_per_file"])
    n = files * per
    rng = np.random.default_rng([seed, 2])
    sizes = size_multiset(cfg["set_sizes"], n)            # ascending
    # stratum s holds sizes[s*files:(s+1)*files]; file f takes one of each
    order = np.stack([rng.permutation(files) for _ in range(per)])
    file_of = np.empty(n, dtype=np.int64)
    for s in range(per):
        file_of[s * files + order[s]] = np.arange(files)
    rel = traffic["relatives"]
    counts = np.zeros(n, dtype=np.int64)
    for f in range(files):
        mine = np.flatnonzero(file_of == f)
        mine = mine[rng.permutation(len(mine))]
        clusters = [int(c) for c in rel["clusters"]]
        small = [q for q in mine if sizes[q] <= rel["cluster_max_size"]]
        for c, q in zip(clusters, small):
            counts[q] = c
        rest = [q for q in mine if counts[q] == 0]
        n_rel = int(round(rel["share"] * per)) - len(clusters)
        cyc = [int(c) for c in rel["counts"]]
        for k, q in enumerate(rest[:n_rel]):
            counts[q] = cyc[k % len(cyc)]
    lo, hi = rel["jaccard"]
    total = int(counts.sum())
    jac = np.linspace(lo, hi, total)[rng.permutation(total)]
    hashes = [np.unique(rng.integers(0, 2**64, size=int(s), dtype=np.uint64))
              for s in sizes]
    return {"sizes": sizes, "file_of": file_of, "counts": counts,
            "jaccard": jac, "hashes": hashes}


def relatives(pool: dict, seed: int) -> tuple[list, np.ndarray]:
    """Hash sets of the planted relatives: a relative of query q at Jaccard
    J has q's size n and shares round(2 n J / (1 + J)) of q's hashes.
    -> (hash arrays, the query of each)."""
    rng = np.random.default_rng([seed, 3])
    sets, owner = [], []
    k = 0
    for q, c in enumerate(pool["counts"]):
        h = pool["hashes"][q]
        for _ in range(int(c)):
            J = float(pool["jaccard"][k])
            k += 1
            s = min(len(h), int(round(2 * len(h) * J / (1 + J))))
            keep = rng.choice(h, size=s, replace=False)
            fresh = rng.integers(0, 2**64, size=len(h) - s, dtype=np.uint64)
            sets.append(np.unique(np.concatenate([keep, fresh])))
            owner.append(q)
    return sets, np.asarray(owner, dtype=np.int64)


def csr(sets: list) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(sets) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in sets], out=offsets[1:])
    flat = np.concatenate(sets) if sets else np.empty(0, np.uint64)
    return flat.astype(np.uint64), offsets


def write_query_files(folder: str, pool: dict) -> list[str]:
    """One ``<id>: h1 h2 ...`` file a request (the upstream search input)."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for f in range(int(pool["file_of"].max()) + 1):
        path = os.path.join(folder, f"queries_{f:02d}.txt")
        with open(path, "w") as out:
            for q in np.flatnonzero(pool["file_of"] == f):
                out.write(f"Q{q:05d}: "
                          + " ".join(map(str, pool["hashes"][q].tolist()))
                          + "\n")
        paths.append(path)
    return paths


def file_queries(pool: dict, f: int) -> np.ndarray:
    """Query ids of file f, in the file's line order."""
    return np.flatnonzero(pool["file_of"] == f)
