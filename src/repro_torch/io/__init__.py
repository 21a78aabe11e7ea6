"""Real-graph ingestion: parse -> preprocess -> build -> store.

  * :mod:`repro_torch.io.formats`     chunked MatrixMarket / SNAP parsers
    and writers; large files stream in fixed-size blocks.
  * :mod:`repro_torch.io.preprocess`  the paper's §4.1 cleaning pipeline
    (canonicalize, drop self loops, dedup, unit weights, optional
    largest component / compact ids) with before/after stats.
  * :mod:`repro_torch.io.store`       content-hash-keyed on-disk CSR
    store, shared with the JAX package's; :func:`load_graph` is the
    parse-once, load-forever entry point.
  * :mod:`repro_torch.io.registry`    named datasets
    (``datasets.get(name)``): synthetic built-ins and registered files
    behind one lookup.

All of it is host numpy; graphs come back on the host, and the engine
moves them to its device.
"""
from repro_torch.io import registry as datasets  # noqa: F401
from repro_torch.io.formats import (  # noqa: F401
    EdgeList,
    FormatError,
    open_graph_bytes,
    parse_edge_file,
    parse_mtx,
    parse_snap,
    sniff_format,
    write_mtx,
    write_snap,
)
from repro_torch.io.preprocess import (  # noqa: F401
    PreprocessOptions,
    PreprocessStats,
    connected_components,
    preprocess,
)
from repro_torch.io.store import (  # noqa: F401
    CsrStore,
    EntryHandle,
    IngestReport,
    default_cache_dir,
    file_content_hash,
    load_graph,
    open_graph,
)
