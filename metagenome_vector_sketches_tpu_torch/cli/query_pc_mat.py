"""query_pc_mat: top-k and sliced queries over a pairwise matrix
(reference CLI: src/query_pc_mat.cpp:242-366).

Queries decode the shard files on the host; the port shares the JAX
package's query stack (which imports no JAX) unchanged.
"""

from __future__ import annotations

import sys

from ..host import query_pc_mat_main


def main(argv=None) -> int:
    return query_pc_mat_main(argv)


if __name__ == "__main__":
    sys.exit(main())
