"""Query output writers, byte-compatible with query_pc_mat.cpp.

- top-k query: one file per query, `<ID>_<outfile>` in outfile's directory,
  header "ID<sep>Jaccard", one line per neighbor (query_pc_mat.cpp:108-127).
- sliced query: csv/tsv with Accession header, or npy/npz row-append
  (query_pc_mat.cpp:166-215; the reference writes npy format even for the
  .npz extension — replicated).

Floats are printed as C++ `ostream << float` does: 6 significant digits of
the double-promoted float32 value.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.npyio import NpyAppender


def format_float(x) -> str:
    """C++ default `<<` formatting for a float value."""
    return f"{float(np.float32(x)):.6g}"


def split_path(fullpath: str):
    """query_pc_mat.cpp:38-47 — (filename, parent)."""
    head, tail = os.path.split(fullpath)
    return tail, (head if head else "./")


def get_file_extension(filename: str) -> str:
    dot = filename.rfind(".")
    return filename[dot + 1:] if dot >= 0 else ""


def sep_for_extension(ext: str) -> str:
    return "," if ext == "csv" else "\t"


def write_topk_result(res, out_fn: str, sep: str, top_n: int,
                      show_all: bool) -> str:
    """Write one query's neighbor file; returns its path."""
    fname, parent = split_path(out_fn)
    path = os.path.join(parent, f"{res.self_id}_{fname}")
    n = len(res.neighbor_ids) if show_all else min(top_n, len(res.neighbor_ids))
    with open(path, "w") as out:
        out.write(f"ID{sep}Jaccard\n")
        for j in range(n):
            out.write(f"{res.neighbor_ids[j]}{sep}"
                      f"{format_float(res.jaccard_similarities[j])}\n")
    return path


class SlicedWriter:
    """Streaming writer for the sliced query (csv/tsv text or npy binary)."""

    def __init__(self, out_fn: str, col_ids: list[str], sep: str):
        self.sep = sep
        self.out_fn = out_fn
        if sep == "-1":
            self.npy = NpyAppender(out_fn, dtype=np.float32)
            self.text = None
        else:
            self.npy = None
            self.text = open(out_fn, "w")
            self.text.write("Accession" + sep)
            for cid in col_ids:
                self.text.write(cid + sep)
            self.text.write("\n")

    def write_row(self, row_id: str, values: np.ndarray) -> None:
        if self.npy is not None:
            self.npy.append(values.astype(np.float32).reshape(1, -1))
        else:
            self.text.write(row_id + self.sep)
            for v in values:
                self.text.write(format_float(v) + self.sep)
            self.text.write("\n")

    def close(self) -> None:
        if self.npy is not None:
            self.npy.close()
        if self.text is not None:
            self.text.close()
