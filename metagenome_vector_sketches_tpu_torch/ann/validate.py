"""Ground-truth validation of the ANN path (reference jaccard.py test(),
:226-325): sample accessions, search the index, recompute TRUE Jaccard from
the raw hash sets, and compare (optionally scatter-plot estimated vs true).

Port of ``metagenome_vector_sketches_tpu/ann/validate.py``: the same
sampling and output, with the search on ``device``.
"""

from __future__ import annotations

import os
import random
import tempfile

from ..io.dbfolder import DbFolder
from ..io.hashes import parse_hashes_file, write_hashes_file
from .search import search_index


def validate(index_folder: str, hashes_file: str, n_samples: int = 20,
             j: float = 0.05, seed: int | None = None, plot: bool = False,
             save_plot: str | None = None, verbose: bool = True,
             engine: str = "f32", mesh_devices: int = 1, *, device):
    """Returns [(query_id, neighbor_id, estimated_jaccard, true_jaccard)].

    Requires the all_hashes.txt-style file the db was built from, and (for
    engine='f32') a built faiss.index in index_folder; the int8 engines
    stage straight from the db's integer vectors."""
    db = DbFolder(index_folder)
    names, _ = db.names_and_norms()
    rng = random.Random(seed)
    samples = set(rng.sample(names, min(n_samples, len(names))))

    named = parse_hashes_file(hashes_file)
    hashes = {n: set(int(x) for x in h) for n, h in named}

    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        qpath = f.name
    query_order = [n for n, _ in named if n in samples]
    write_hashes_file(qpath, [(n, h) for n, h in named if n in samples])
    try:
        folder = index_folder if index_folder.endswith("/") \
            else index_folder + "/"
        neighbors = search_index(folder, qpath, j, verbose=False,
                                 engine=engine, mesh_devices=mesh_devices,
                                 device=device)
    finally:
        os.unlink(qpath)

    results = []
    for qidx, nid, est in neighbors:
        qid = query_order[qidx]
        s1, s2 = hashes.get(qid), hashes.get(nid)
        if not s1 or not s2:
            continue
        true = len(s1 & s2) / len(s1 | s2)
        results.append((qid, nid, est, true))
        if verbose:
            print(f"{qid} vs {nid}: vector_jaccard={est:.4f}, "
                  f"hash_jaccard={true:.4f}")

    if (plot or save_plot) and results:
        import matplotlib
        if save_plot:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        xs = [r[3] for r in results]
        ys = [r[2] for r in results]
        plt.figure(figsize=(6, 6))
        plt.scatter(xs, ys, alpha=0.1)
        lo, hi = min(xs + ys), max(xs + ys)
        plt.plot([lo, hi], [lo, hi], color="red", linestyle="--",
                 label="x = y")
        plt.xlabel("True Jaccard")
        plt.ylabel("Estimated Jaccard")
        plt.legend()
        if save_plot:
            plt.savefig(save_plot)
        else:
            plt.show()
        plt.close()
    return results
