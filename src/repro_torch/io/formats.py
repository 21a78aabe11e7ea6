"""Chunked parsers/writers for real graph files: MatrixMarket + SNAP.

The paper's evaluation corpus (Table 1) is SuiteSparse MatrixMarket
files up to 3.8B edges; SNAP distributes the social-network graphs as
``#``-commented whitespace edge lists.  Both parsers here stream the
file in fixed-size byte blocks and tokenize each block with NumPy-level
primitives (``bytes.split`` + one ``np.array`` over the token buffer),
so a multi-gigabyte file is never materialised as per-line Python
objects — peak host memory is one block plus the accumulated edge
arrays.

Outputs are :class:`EdgeList` — the raw on-file edge set, **exactly as
stored** (1-based ids already shifted to 0-based, symmetric-storage
mirroring already expanded, but *no* dedup / self-loop / weight
normalisation).  Cleaning is :mod:`repro_torch.io.preprocess`'s job; keeping
the stages separate is what lets the preprocessing stats report the raw
vs. cleaned edge counts the paper's §4.1 table shows.

Format notes:

* MatrixMarket coordinate (``.mtx``): ``%%MatrixMarket matrix
  coordinate {real|integer|pattern} {general|symmetric}`` header,
  ``%``-comment lines, one ``rows cols nnz`` size line, then ``i j
  [v]`` entries, 1-based.  ``symmetric`` storage keeps one triangle;
  the parser mirrors off-diagonal entries so downstream code always
  sees the full undirected edge set.  ``pattern`` files carry no
  values (unit weights — the paper's default for every graph).
* SNAP / whitespace edge lists (``.snap.txt``, ``.edges``, ``.txt``):
  ``#``-comment lines, ``u v [w]`` per line, 0- or 1-based (SNAP files
  are 0-based; ``one_based=True`` shifts).  No vertex-count header —
  ``n`` is inferred as ``max_id + 1`` unless given.
* gzip: both parsers read through :func:`open_graph_bytes`, which
  detects the gzip magic bytes and streams the decompressed member
  block-by-block — SuiteSparse/SNAP downloads ship compressed, and a
  ``.mtx.gz`` never has to be unpacked on disk.
"""
from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path

import numpy as np

DEFAULT_BLOCK_BYTES = 4 << 20  # 4 MiB per streamed block
_GZIP_MAGIC = b"\x1f\x8b"


def open_graph_bytes(path):
    """Binary reader for a graph file, transparently gunzipping.

    Detection is by magic bytes, not extension, so ``file.mtx.gz`` and a
    misnamed ``file.mtx`` that is really gzip both work.  The gzip
    member streams block-by-block through the same
    :func:`_iter_blocks` path as plain files — the decompressed file is
    never materialized.
    """
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == _GZIP_MAGIC:
        return gzip.open(path, "rb")
    return open(path, "rb")


@dataclasses.dataclass
class EdgeList:
    """A raw parsed edge set (host-side, pre-preprocessing).

    ``edges`` is (E, 2) int64; ``weights`` is (E,) float64 or None
    (pattern/unweighted files — unit weights downstream).  ``n`` is the
    declared or inferred vertex count.  ``meta`` records provenance
    (format, header fields, symmetric storage, comment/blank counts)
    for the ingest CLI's ``--stats`` report.
    """
    edges: np.ndarray
    weights: np.ndarray | None
    n: int
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def max_id(self) -> int:
        return int(self.edges.max()) if len(self.edges) else -1


class FormatError(ValueError):
    """Malformed graph file (bad header, ragged columns, id overflow)."""


# --- block streaming -------------------------------------------------------

def _iter_blocks(fh, block_bytes: int):
    """Yield byte blocks ending on line boundaries (tail carried over)."""
    carry = b""
    while True:
        block = fh.read(block_bytes)
        if not block:
            if carry:
                yield carry
            return
        block = carry + block
        cut = block.rfind(b"\n")
        if cut < 0:
            carry = block
            continue
        carry = block[cut + 1:]
        yield block[: cut + 1]


def _tokenize(block: bytes, comment: bytes) -> tuple[list[bytes], int]:
    """Split a block into whitespace tokens, dropping comment lines.

    Returns (tokens, lines_dropped).  The fast path — no comment marker
    anywhere in the block — is one C-level ``split``; blocks containing
    comments fall back to a per-line filter (headers cluster at the top
    of real files, so ~all payload blocks take the fast path).
    """
    if comment not in block:
        return block.split(), 0
    kept, dropped = [], 0
    for line in block.splitlines():
        if line.lstrip().startswith(comment):
            dropped += 1
        else:
            kept.append(line)
    return b" ".join(kept).split(), dropped


def _parse_columns(tokens: list[bytes], ncols: int, where: str):
    """Tokens -> (rows, ncols) float64 array (one vectorized np.array)."""
    if len(tokens) % ncols:
        raise FormatError(
            f"{where}: token count {len(tokens)} is not a multiple of "
            f"{ncols} columns — ragged or truncated entry lines")
    arr = np.array(tokens, dtype=np.float64)
    return arr.reshape(-1, ncols)


# --- MatrixMarket ----------------------------------------------------------

_MM_FIELDS = ("real", "integer", "pattern")
_MM_SYMMETRIES = ("general", "symmetric")


def _read_mtx_header(fh):
    """Consume banner + comments + size line; return (field, symmetry,
    (rows, cols, nnz), header_lines)."""
    banner = fh.readline()
    parts = banner.split()
    if len(parts) < 5 or parts[0] != b"%%MatrixMarket" \
            or parts[1] != b"matrix" or parts[2] != b"coordinate":
        raise FormatError(
            "not a MatrixMarket coordinate file (banner "
            f"{banner[:60]!r}); array-format .mtx is not a graph")
    field = parts[3].decode().lower()
    symmetry = parts[4].decode().lower()
    if field == "complex":
        raise FormatError("complex-valued .mtx is not a weighted graph")
    if field not in _MM_FIELDS:
        raise FormatError(f"unsupported .mtx field {field!r}")
    if symmetry in ("skew-symmetric", "hermitian"):
        raise FormatError(f".mtx symmetry {symmetry!r} has no undirected-"
                          "graph reading (negative/conjugate mirrors)")
    if symmetry not in _MM_SYMMETRIES:
        raise FormatError(f"unsupported .mtx symmetry {symmetry!r}")
    header_lines = 1
    while True:
        line = fh.readline()
        if not line:
            raise FormatError("missing .mtx size line")
        header_lines += 1
        stripped = line.strip()
        if not stripped or stripped.startswith(b"%"):
            continue
        dims = stripped.split()
        if len(dims) != 3:
            raise FormatError(f"bad .mtx size line {line!r}")
        rows, cols, nnz = (int(x) for x in dims)
        if rows != cols:
            raise FormatError(
                f"rectangular matrix ({rows}x{cols}) is not an adjacency "
                "matrix — row and column ids name different entity sets "
                "(bipartite data needs an explicit projection first)")
        return field, symmetry, (rows, cols, nnz), header_lines


def parse_mtx(path, block_bytes: int = DEFAULT_BLOCK_BYTES) -> EdgeList:
    """Parse a MatrixMarket coordinate file into a raw :class:`EdgeList`.

    Ids come back 0-based; symmetric storage is expanded (off-diagonal
    entries mirrored) so the edge set matches what a ``general`` file of
    the same graph would hold.  Pattern files yield ``weights=None``.
    """
    path = Path(path)
    with open_graph_bytes(path) as fh:
        field, symmetry, (rows, cols, nnz), _ = _read_mtx_header(fh)
        ncols = 2 if field == "pattern" else 3
        chunks, comment_lines = [], 0
        for block in _iter_blocks(fh, block_bytes):
            tokens, dropped = _tokenize(block, b"%")
            comment_lines += dropped
            if tokens:
                chunks.append(_parse_columns(tokens, ncols, path.name))
    data = np.concatenate(chunks, axis=0) if chunks \
        else np.zeros((0, ncols), np.float64)
    if len(data) != nnz:
        raise FormatError(f"{path.name}: header promises {nnz} entries, "
                          f"file holds {len(data)}")
    edges = data[:, :2].astype(np.int64) - 1  # 1-based -> 0-based
    if len(edges) and edges.min() < 0:
        raise FormatError(f"{path.name}: entry ids below 1 in a 1-based "
                          "coordinate file")
    weights = None if field == "pattern" else data[:, 2].copy()
    mirrored = 0
    if symmetry == "symmetric":
        off_diag = edges[:, 0] != edges[:, 1]
        mirrored = int(off_diag.sum())
        edges = np.concatenate([edges, edges[off_diag][:, ::-1]], axis=0)
        if weights is not None:
            weights = np.concatenate([weights, weights[off_diag]])
    n = rows
    if len(edges) and edges.max() >= n:
        raise FormatError(f"{path.name}: entry id {edges.max() + 1} "
                          f"exceeds declared dimension {n}")
    return EdgeList(edges=edges, weights=weights, n=n, meta={
        "format": "mtx", "field": field, "symmetry": symmetry,
        "declared_shape": (rows, cols), "declared_nnz": nnz,
        "mirrored_entries": mirrored, "comment_lines": comment_lines,
    })


# --- SNAP / whitespace edge lists -----------------------------------------

def parse_snap(path, one_based: bool = False, n: int | None = None,
               block_bytes: int = DEFAULT_BLOCK_BYTES) -> EdgeList:
    """Parse a SNAP-style whitespace edge list (``#`` comments).

    Column count (2 = unweighted, 3 = weighted) is detected from the
    first data block and enforced for the rest of the file.  ``n``
    defaults to ``max_id + 1`` after the optional 1-based shift.
    """
    path = Path(path)
    chunks, comment_lines, ncols = [], 0, None
    with open_graph_bytes(path) as fh:
        for block in _iter_blocks(fh, block_bytes):
            tokens, dropped = _tokenize(block, b"#")
            comment_lines += dropped
            if not tokens:
                continue
            if ncols is None:
                for line in block.splitlines():
                    first = line.split()
                    if first and not first[0].startswith(b"#"):
                        ncols = len(first)
                        break
                if ncols not in (2, 3):
                    raise FormatError(
                        f"{path.name}: edge lines must be 'u v' or "
                        f"'u v w', first data line has {ncols} columns")
            chunks.append(_parse_columns(tokens, ncols, path.name))
    if ncols is None:
        ncols = 2
    data = np.concatenate(chunks, axis=0) if chunks \
        else np.zeros((0, ncols), np.float64)
    edges = data[:, :2].astype(np.int64)
    if one_based:
        edges -= 1
    if len(edges) and edges.min() < 0:
        raise FormatError(f"{path.name}: negative vertex ids "
                          f"(wrong --one-based setting?)")
    weights = data[:, 2].copy() if ncols == 3 else None
    inferred = int(edges.max()) + 1 if len(edges) else 0
    if n is None:
        n = max(inferred, 1)
    elif inferred > n:
        raise FormatError(f"{path.name}: vertex id {inferred - 1} exceeds "
                          f"given n={n}")
    return EdgeList(edges=edges, weights=weights, n=int(n), meta={
        "format": "snap", "one_based": one_based,
        "weighted": weights is not None, "comment_lines": comment_lines,
    })


# --- format dispatch -------------------------------------------------------

def sniff_format(path) -> str:
    """``"mtx"`` or ``"snap"``, by extension then content.

    A trailing ``.gz`` is ignored for extension sniffing, and content
    sniffing reads through the transparent-decompression layer, so
    gzipped files resolve to the format of their payload.
    """
    path = Path(path)
    suffixes = [s.lower() for s in path.suffixes if s.lower() != ".gz"]
    if ".mtx" in suffixes:
        return "mtx"
    if any(s in suffixes for s in (".snap", ".edges", ".el")):
        return "snap"
    with open_graph_bytes(path) as fh:
        head = fh.read(64)
    return "mtx" if head.startswith(b"%%MatrixMarket") else "snap"


def parse_edge_file(path, fmt: str | None = None, **kw) -> EdgeList:
    """Dispatch to :func:`parse_mtx` / :func:`parse_snap` by format."""
    fmt = fmt or sniff_format(path)
    if fmt == "mtx":
        kw.pop("one_based", None)  # .mtx is 1-based by definition
        return parse_mtx(path, **kw)
    if fmt == "snap":
        return parse_snap(path, **kw)
    raise FormatError(f"unknown graph format {fmt!r}")


# --- writers (fixtures, benchmarks, property tests) ------------------------

def write_mtx(path, edges, weights=None, n: int | None = None,
              symmetric: bool = False) -> None:
    """Write an edge list as MatrixMarket coordinate (1-based).

    ``symmetric=True`` stores the lower triangle only (entries are
    canonicalised to ``row >= col``), the SuiteSparse convention for
    undirected graphs; the parser mirrors them back.  Weights print at
    ``%.17g`` so a float64 round-trips bit-exactly through the text.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if n is None:
        n = int(edges.max()) + 1 if len(edges) else 1
    field = "pattern" if weights is None else "real"
    symmetry = "symmetric" if symmetric else "general"
    if symmetric:
        lo = edges.min(axis=1)
        hi = edges.max(axis=1)
        edges = np.stack([hi, lo], axis=1)  # row >= col (lower triangle)
    with open(path, "w") as fh:
        fh.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        fh.write(f"% written by repro_torch.io ({len(edges)} entries)\n")
        fh.write(f"{n} {n} {len(edges)}\n")
        if weights is None:
            for u, v in (edges + 1).tolist():
                fh.write(f"{u} {v}\n")
        else:
            weights = np.asarray(weights, dtype=np.float64).reshape(-1)
            for (u, v), w in zip((edges + 1).tolist(), weights.tolist()):
                fh.write(f"{u} {v} {w:.17g}\n")


def write_snap(path, edges, weights=None, comment: str | None = None) -> None:
    """Write a SNAP-style edge list (0-based, ``#`` header comment)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    with open(path, "w") as fh:
        fh.write(f"# {comment or 'written by repro_torch.io'}\n")
        fh.write(f"# Nodes: {int(edges.max()) + 1 if len(edges) else 0} "
                 f"Edges: {len(edges)}\n")
        if weights is None:
            for u, v in edges.tolist():
                fh.write(f"{u}\t{v}\n")
        else:
            weights = np.asarray(weights, dtype=np.float64).reshape(-1)
            for (u, v), w in zip(edges.tolist(), weights.tolist()):
                fh.write(f"{u}\t{v}\t{w:.17g}\n")
