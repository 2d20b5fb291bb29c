"""FracMinHash sets made from the seed, for the MinHash cells: the hash sets
of a collection of accessions and their ``all_hashes.txt``, the upstream's
``project_everything convert`` output (one ``<accession>: h1 h2 ...`` line a
set).

Set sizes and planted groups are those of the sketch configurations
(``gen.layout``: a fixed multiset of sizes, placed by the seed). Every
hash of a set is, with probability ``share``, drawn from a pool of
``pool_size`` hashes shared by the whole collection, by Zipf rank
popularity of exponent ``zipf_exponent``, and is otherwise private: held by
that set alone, or by the members of its planted group alone (the group's
shared part, which draws from the pool in the same proportion). A set's
draws are distinct: a pool rank drawn twice for one set is drawn again, so
the sizes are exact.

Hash values: an id (pool rank, or a private counter) offset by the seed and
put through a bijection of 53-bit integers, so every value is distinct and
below 2^53 < floor(2^64 / 1000), the FracMinHash range at scale 1000.

Everything is made on ``device`` in bulk; the text is formatted there too.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen

BITS = 53
MASK = (1 << BITS) - 1
_M1, _M2 = 0x9E3779B97F4A7C15 & MASK | 1, 0xBF58476D1CE4E5B9 & MASK | 1
# hashes a chunk of the text (bounds the formatting's device memory)
TEXT_CHUNK = 1 << 23
DIGITS = 16                      # 2^53 < 10^16
NAME_WIDTH = 11                  # "ACC0000000:"


def mix53(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^53) (xor-shifts and odd multipliers mod 2^53)."""
    x = (x ^ (x >> 29)) & MASK
    x = (x * _M1) & MASK
    x = (x ^ (x >> 32)) & MASK
    x = (x * _M2) & MASK
    return x ^ (x >> 29)


def zipf_cdf(pool: int, exponent: float, device) -> torch.Tensor:
    """The cumulative popularity of ranks 1..pool, float64, ending at 1."""
    w = torch.arange(1, pool + 1, dtype=torch.float64,
                     device=device).pow_(-exponent)
    c = torch.cumsum(w, 0)
    return c / c[-1]


def distinct_draws(need: torch.Tensor, cdf: torch.Tensor,
                   gen_: torch.Generator, req_owner=None, req_rank=None):
    """For each owner o, need[o] distinct pool ranks by Zipf popularity, none
    of them among its required ranks (req_owner, req_rank). Ranks are drawn
    with replacement; those an owner holds already are dropped and the
    deficit drawn again, a random choice of the new distinct ones kept.
    -> (owner, rank) int64, sorted by owner."""
    dev = need.device
    pool = len(cdf)
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    req_owner = empty if req_owner is None else req_owner
    req_rank = empty if req_rank is None else req_rank
    held = need + torch.bincount(req_owner, minlength=len(need))
    if len(need) and int(held.max()) > pool:
        raise ValueError("an owner needs more distinct ranks than the pool "
                         "holds")
    own, rank = empty, empty
    deficit = need.clone()
    while bool((deficit > 0).any()):
        m = torch.where(deficit > 0, deficit + deficit // 4 + 4, 0)
        o = torch.repeat_interleave(torch.arange(len(need), device=dev), m)
        u = torch.rand(len(o), dtype=torch.float64, device=dev,
                       generator=gen_)
        r = torch.searchsorted(cdf, u, right=True).clamp_(max=pool - 1)
        allo = torch.cat([req_owner, own, o])
        allr = torch.cat([req_rank, rank, r])
        prio = torch.cat([torch.zeros_like(req_owner), torch.ones_like(own),
                          torch.full_like(o, 2)])
        key, order = torch.sort((allo * pool + allr) * 3 + prio)
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] // 3 != key[:-1] // 3
        new = order[first & (key % 3 == 2)]
        no = allo[new]
        # a random choice of each owner's new ranks, deficit[o] of them
        shuffle = torch.randperm(len(new), device=dev, generator=gen_)
        no_s = no[shuffle]
        by_owner = torch.sort(no_s, stable=True).indices
        pick = shuffle[by_owner]
        po = no[pick]
        start = torch.searchsorted(po, po, right=False)
        keep = torch.arange(len(po), device=dev) - start < deficit[po]
        pick = new[pick[keep]]
        own = torch.cat([own, allo[pick]])
        rank = torch.cat([rank, allr[pick]])
        deficit = need - torch.bincount(own, minlength=len(need))
    order = torch.sort(own, stable=True).indices
    return own[order], rank[order]


def make_sets(cfg: dict, seed: int, device) -> dict:
    """-> {"hashes": (H,) int64 values, each set's sorted, "offsets": (N+1,)
    int64, "sizes": (N,) int64}, on ``device``."""
    dev = torch.device(device)
    n = int(cfg["num_sets"])
    lay = gen.layout(dict(cfg, num_vectors=n), seed)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    share = float(cfg["sharing"]["share"])
    pool = int(cfg["sharing"]["pool_size"])
    cdf = zipf_cdf(pool, float(cfg["sharing"]["zipf_exponent"]), dev)
    private = torch.from_numpy(lay["private"]).to(dev)
    shared = torch.from_numpy(lay["shared"]).to(dev)
    group_of = torch.from_numpy(lay["group_of"]).to(dev)

    def split(sizes):
        k = torch.binomial(sizes.to(torch.float64),
                           torch.full(sizes.shape, share, dtype=torch.float64,
                                      device=dev), generator=g)
        return k.to(torch.int64)

    # the groups' shared parts, then each set's own part, distinct from its
    # group's pool ranks
    g_pool = split(shared)
    go, gr = distinct_draws(g_pool, cdf, g)
    member = torch.nonzero(group_of >= 0).flatten()
    gm = group_of[member]
    per = torch.bincount(go, minlength=len(shared))
    gstart = torch.cumsum(per, 0) - per
    cnt = per[gm]
    req_owner = torch.repeat_interleave(member, cnt)
    idx = torch.repeat_interleave(gstart[gm], cnt) + (
        torch.arange(int(cnt.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt))
    req_rank = gr[idx]
    s_pool = split(private)
    so, sr = distinct_draws(s_pool, cdf, g, req_owner, req_rank)

    # private ids after the pool's: the groups' fresh hashes, then the sets'
    g_fresh = shared - g_pool
    s_fresh = private - s_pool
    g_first = pool + torch.cumsum(g_fresh, 0) - g_fresh
    s_first = pool + int(g_fresh.sum()) + torch.cumsum(s_fresh, 0) - s_fresh

    def runs(first, count, owner_ids):
        o = torch.repeat_interleave(owner_ids, count)
        total = int(count.sum())
        ids = torch.repeat_interleave(first, count) + (
            torch.arange(total, device=dev)
            - torch.repeat_interleave(torch.cumsum(count, 0) - count, count))
        return o, ids

    fo, fid = runs(g_first[gm], g_fresh[gm], member)
    po, pid = runs(s_first, s_fresh, torch.arange(n, device=dev))
    owner = torch.cat([req_owner, so, fo, po])
    ids = torch.cat([req_rank, sr, fid, pid])
    salt = int(np.random.default_rng([seed, 6]).integers(0, 1 << BITS))
    h = mix53((ids + salt) & MASK)
    order = torch.argsort(h)
    h, o = h[order], owner[order]
    o, order = torch.sort(o, stable=True)
    h = h[order]
    sizes = torch.bincount(o, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(sizes, 0)
    want = torch.from_numpy(lay["sizes"]).to(dev)
    if not torch.equal(sizes, want):
        raise AssertionError("hash sets of the wrong sizes")
    return {"hashes": h, "offsets": offsets, "sizes": sizes}


def _name_rows(first: int, count: int, dev) -> torch.Tensor:
    """(count, NAME_WIDTH) uint8 rows "ACC%07d:" for sets first.."""
    i = torch.arange(first, first + count, device=dev, dtype=torch.int64)
    p10 = 10 ** torch.arange(6, -1, -1, device=dev, dtype=torch.int64)
    digits = (i[:, None] // p10) % 10 + ord("0")
    head = torch.tensor([ord(c) for c in "ACC"], device=dev,
                        dtype=torch.int64).expand(count, 3)
    colon = torch.full((count, 1), ord(":"), device=dev, dtype=torch.int64)
    return torch.cat([head, digits, colon], 1).to(torch.uint8)


def write_hashes_text(path: str, sets: dict) -> int:
    """Write the sets as ``ACC%07d: h1 h2 ...`` lines (hashes in decimal,
    each set's in ascending order; ``ACC%07d:`` alone for an empty set),
    formatted on the sets' device a chunk of sets at a time. -> bytes
    written."""
    h, off = sets["hashes"], sets["offsets"]
    dev = h.device
    n = len(off) - 1
    off_h = off.cpu().numpy()
    p10 = 10 ** torch.arange(DIGITS - 1, -1, -1, device=dev,
                             dtype=torch.int64)
    width = 1 + DIGITS + 1           # " " digits "\n"
    written = 0
    with open(path, "wb") as f:
        a = 0
        while a < n:
            b = int(np.searchsorted(off_h, off_h[a] + TEXT_CHUNK,
                                    side="right")) - 1
            b = min(n, max(b, a + 1))
            lo, hi = int(off_h[a]), int(off_h[b])
            rows = (b - a) + (hi - lo)
            M = torch.zeros((rows, width), dtype=torch.uint8, device=dev)
            keep = torch.zeros((rows, width), dtype=torch.bool, device=dev)
            sizes = off[a + 1:b + 1] - off[a:b]
            name_row = torch.arange(b - a, device=dev) + (off[a:b] - lo)
            M[name_row, :NAME_WIDTH] = _name_rows(a, b - a, dev)
            keep[name_row, :NAME_WIDTH] = True
            empty = name_row[sizes == 0]
            M[empty, -1] = ord("\n")
            keep[empty, -1] = True
            v = h[lo:hi]
            set_of = torch.repeat_interleave(
                torch.arange(b - a, device=dev), sizes)
            hrow = torch.arange(hi - lo, device=dev) + set_of + 1
            digits = (v[:, None] // p10) % 10
            ndig = torch.clamp(DIGITS - (digits.cumsum(1) == 0).sum(1), min=1)
            M[hrow, 0] = ord(" ")
            M[hrow, 1:1 + DIGITS] = (digits + ord("0")).to(torch.uint8)
            col = torch.arange(DIGITS, device=dev)
            kh = torch.zeros((hi - lo, width), dtype=torch.bool, device=dev)
            kh[:, 0] = True
            kh[:, 1:1 + DIGITS] = col[None, :] >= DIGITS - ndig[:, None]
            last = torch.zeros(hi - lo, dtype=torch.bool, device=dev)
            ends = off[a + 1:b + 1] - lo - 1
            last[ends[sizes > 0]] = True
            kh[:, -1] = last
            M[hrow[last], -1] = ord("\n")
            keep[hrow] = kh
            out = M[keep].cpu().numpy()
            out.tofile(f)
            written += len(out)
            del M, keep, digits, kh
            a = b
    return written
