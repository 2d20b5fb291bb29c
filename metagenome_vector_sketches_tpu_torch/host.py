"""The host layers the port shares with the JAX package.

These modules of ``metagenome_vector_sketches_tpu`` import no JAX (a fresh
interpreter that imports them never loads ``jax``), so the port uses them
unchanged instead of copying them: the on-disk contracts (hashes files, db
folders, matrix shards, the FAISS IndexFlat file of ``faissio``), the
codecs behind them, the shard reader, the query engine and the command-line
parsers. Everything of the port that needs them imports them from
here, so this file is the full list.
"""

from metagenome_vector_sketches_tpu.ann import faissio  # noqa: F401
from metagenome_vector_sketches_tpu.cli import jaccard as jaccard_cli  # noqa: F401
from metagenome_vector_sketches_tpu.cli.pairwise_comp import (  # noqa: F401
    build_parser as pairwise_comp_parser, tile_from_memory)
from metagenome_vector_sketches_tpu.cli.query_pc_mat import (  # noqa: F401
    main as query_pc_mat_main)
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: F401
from metagenome_vector_sketches_tpu.io.hashes import (  # noqa: F401
    parse_hashes_file, parse_query_hashes_file, write_hashes_file)
from metagenome_vector_sketches_tpu.io.ingest import convert  # noqa: F401
from metagenome_vector_sketches_tpu.matrix.reader import (  # noqa: F401
    MatrixReader)
from metagenome_vector_sketches_tpu.matrix.writer import (  # noqa: F401
    quantize_jaccard, write_shard)
from metagenome_vector_sketches_tpu.query import engine as query_engine  # noqa: F401
from metagenome_vector_sketches_tpu.utils.log import log  # noqa: F401
