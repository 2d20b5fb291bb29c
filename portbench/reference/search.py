"""Plain reference of the upstream search (jaccard.py ``search_index``):
query vectors from the query hash sets, cosines against every db row, the
expanding search k = 50 * 3^level, and the Jaccard rescoring.

Semantics: a query's scores are the cosines of its projected vector with
every db row; at each level the top nb = 50 * 3^level rows are taken; the
search goes deeper while some of them and the nb-th score are above
min_ip = 2 j / (1 + j) and nb < N (two levels when the nb-th score clears
min_ip by 0.05, up to level 19); the hits are the final level's rows whose
J = ip |q| |n| / (|n|^2 + |q|^2 - ip |q| |n|) exceeds j, with |n| the db's
text norm and |q| the float32 norm of the query scaled by 1/sqrt(d).

"exact" computes the cosines from exact integer dots in float64; the
control "float32" computes the dots, the cosines and J in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import exact

FIRST_K = 50
MAX_LEVELS = 20


def query_norms(q_int: np.ndarray, d: int) -> np.ndarray:
    """The float32 norms of the queries scaled by 1/sqrt(d)."""
    q = (q_int.astype(np.float64) / np.sqrt(d)).astype(np.float32)
    return np.linalg.norm(q, axis=1)


def _levels(cos: torch.Tensor, min_ip: float, n: int) -> np.ndarray:
    """Final level of every query (rows of cos) under the expansion."""
    B = cos.shape[0]
    level = np.zeros(B, dtype=np.int64)
    active = np.arange(B)
    while len(active):
        nb = FIRST_K * np.power(3, level[active])
        k = int(min(nb.max(), n))
        top = torch.topk(cos[torch.from_numpy(active).to(cos.device)], k,
                         dim=1).values.double().cpu().numpy()
        nxt = []
        for row, q in enumerate(active):
            nbe = int(min(nb[row], n))
            kth = top[row, nbe - 1]
            if bool((top[row, :nbe] > min_ip).any()) and kth > min_ip \
                    and nb[row] < n:
                if kth - 0.05 > min_ip and level[q] <= MAX_LEVELS - 3:
                    level[q] += 2
                    nxt.append(q)
                elif level[q] <= MAX_LEVELS - 2:
                    level[q] += 1
                    nxt.append(q)
        active = np.asarray(nxt, dtype=np.int64)
    return level


def search(db: dict, q_int: np.ndarray, j: float,
           precision: str = "exact") -> list[dict]:
    """-> for each query, {db row name: J} of its hits. db: gen.read_db's
    dict (vectors on the computing device)."""
    V, d, n = db["V"], db["d"], db["V"].shape[0]
    dev = V.device
    qn = query_norms(q_int, d)
    q = torch.from_numpy(np.ascontiguousarray(q_int, np.int32)).to(dev)
    f32 = precision == "float32"
    ns = V.to(torch.int64).square().sum(1)
    qns = q.to(torch.int64).square().sum(1)
    D = exact.dots(exact.operand(q, precision), exact.operand(V, precision))
    if f32:
        denom = torch.sqrt(ns.float()[None, :] * qns.float()[:, None])
        cos = torch.where(denom > 0, D.float() / denom.clamp(min=1e-30),
                          torch.zeros_like(denom))
    else:
        denom = torch.sqrt(ns.double()[None, :] * qns.double()[:, None])
        cos = torch.where(denom > 0, D.double() / denom.clamp(min=1e-300),
                          torch.zeros_like(denom))
    min_ip = float(np.float32(2 * j / (1 + j)))
    level = _levels(cos, min_ip, n)
    out = []
    nn_all = db["norms"]
    for b in range(len(q_int)):
        k = int(min(FIRST_K * 3 ** int(level[b]), n))
        idx = torch.topk(cos[b], k).indices
        ip = cos[b, idx].cpu().numpy()
        idx = idx.cpu().numpy()
        nn = nn_all[idx]
        qb = float(qn[b])
        if f32:
            ip, nn, qb = ip.astype(np.float32), nn.astype(np.float32), \
                np.float32(qb)
        with np.errstate(divide="ignore", invalid="ignore"):
            jac = ip * qb * nn / (nn ** 2 + qb ** 2 - ip * qb * nn)
        hit = jac > j
        out.append({db["names"][i]: float(x)
                    for i, x in zip(idx[hit], jac[hit])} if qb != 0 else {})
    return out
