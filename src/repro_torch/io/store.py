"""On-disk CSR cache: parse once, load forever.

Parsing a large MatrixMarket file is minutes of text tokenization; the CSR
it produces is six flat arrays.  :class:`CsrStore` keeps those arrays under
a key derived from the file's content hash and the preprocessing options,
so :func:`load_graph` parses a (file, options) pair once; every later load,
in any process, maps the stored arrays back.

Layout (one directory per entry), the JAX package's byte for byte, so an
entry written by either package loads in the other:

    <cache_dir>/<key>/meta.json    n / m_pad / num_edges / stats /
                                   fingerprint / array table / provenance
    <cache_dir>/<key>/arrays.bin   row_ptr / src / dst / wgt / edge_mask /
                                   kdeg back to back, 64-byte aligned

A load maps ``arrays.bin`` once, copy-on-write (``mode="c"``), and wraps
the views as tensors without copying them: the graph's host tensors are
the file's pages, read on first touch (the upload to the card reads them).
The saved fingerprint is re-attached, so ``warm_start="auto"`` stays
continuous across processes without a CRC over the edge arrays.

Writes are atomic (temporary directory + ``os.replace``): a crashed ingest
leaves no half-written entry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.core.graph import (
    Graph,
    build_graph,
    graph_fingerprint,
    graph_from_arrays,
)
from repro_torch.io.formats import parse_edge_file, sniff_format
from repro_torch.io.preprocess import PreprocessOptions, preprocess

STORE_VERSION = 2  # bump to invalidate every cached entry
_ARRAYS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
_ALIGN = 64        # per-array alignment inside arrays.bin
_HASH_BLOCK = 4 << 20


def default_cache_dir() -> Path:
    """``$REPRO_GRAPH_CACHE`` or ``~/.cache/repro/graphs`` (the JAX
    package's store: entries are shared)."""
    env = os.environ.get("REPRO_GRAPH_CACHE")
    if env:
        return Path(env)
    return Path(os.environ.get("XDG_CACHE_HOME",
                               Path.home() / ".cache")) / "repro" / "graphs"


def file_content_hash(path) -> str:
    """Streaming sha256 of the file bytes (hex)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(_HASH_BLOCK)
            if not block:
                return h.hexdigest()
            h.update(block)


@dataclasses.dataclass
class IngestReport:
    """What :func:`load_graph` did and how long each stage took."""
    path: str
    key: str
    cache_hit: bool
    parse_seconds: float = 0.0
    preprocess_seconds: float = 0.0
    build_seconds: float = 0.0
    load_seconds: float = 0.0
    hash_seconds: float = 0.0
    save_seconds: float = 0.0
    stats: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _map_arrays(entry_dir: Path, meta: dict) -> dict[str, np.ndarray]:
    """Zero-copy views of every stored array over one copy-on-write map."""
    blob = np.memmap(entry_dir / "arrays.bin", dtype=np.uint8, mode="c")
    views = {}
    for name, dtype, shape, off, nbytes in meta["array_table"]:
        view = blob[off:off + nbytes].view(np.dtype(dtype))
        views[name] = view.reshape([int(s) for s in shape])
    return views


def _graph_of(meta: dict, arrays: dict) -> Graph:
    """The host Graph over the mapped arrays (shared, not copied), with
    the saved fingerprint attached."""
    fp = meta.get("fingerprint")
    return graph_from_arrays(
        int(meta["n"]), int(meta["num_edges"]),
        *(arrays[name] for name in _ARRAYS),
        fingerprint=tuple(fp) if fp is not None else None)


def _read_meta(entry_dir: Path) -> dict | None:
    with open(entry_dir / "meta.json") as fh:
        meta = json.load(fh)
    return meta if meta.get("store_version") == STORE_VERSION else None


class EntryHandle:
    """Windowed zero-copy reads over one stored entry's ``arrays.bin``.

    The out-of-core path slices ``row_ptr`` / ``src`` / ``dst`` / ``wgt``
    windows of a large entry without materializing the full arrays: a
    handle maps the blob once and :meth:`window` returns a view, so a read
    costs only the pages the caller touches.
    """

    def __init__(self, key: str, entry_dir: Path, meta: dict):
        self.key = key
        self.meta = meta
        self.n = int(meta["n"])
        self.m_pad = int(meta["m_pad"])
        self.num_edges = int(meta["num_edges"])
        fp = meta.get("fingerprint")
        self.fingerprint = tuple(fp) if fp is not None else None
        self._views = _map_arrays(entry_dir, meta)

    def array(self, name: str) -> np.ndarray:
        """Full zero-copy view of one stored array."""
        return self._views[name]

    def window(self, name: str, lo: int, hi: int) -> np.ndarray:
        """Zero-copy ``[lo, hi)`` slice of one stored array."""
        return self._views[name][lo:hi]

    def to_graph(self) -> Graph:
        """The full host :class:`Graph` of this entry, as
        :meth:`CsrStore.load` gives it, without opening or hashing anything
        again."""
        return _graph_of(self.meta, self._views)


class CsrStore:
    """Directory of stored CSR graphs keyed by content and options."""

    def __init__(self, cache_dir=None):
        self.root = Path(cache_dir) if cache_dir is not None \
            else default_cache_dir()

    # --- keying ---

    @staticmethod
    def key_for(content_hash: str, opts: PreprocessOptions,
                fmt_token: str) -> str:
        blob = f"v{STORE_VERSION}|{content_hash}|{opts.cache_token()}|" \
               f"{fmt_token}"
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    def entry_dir(self, key: str) -> Path:
        return self.root / key

    def has(self, key: str) -> bool:
        return (self.entry_dir(key) / "meta.json").is_file()

    # --- load / save ---

    def load(self, key: str) -> tuple[Graph, dict] | None:
        """(host Graph, meta) of a stored entry, or None on a miss or a
        damaged entry."""
        d = self.entry_dir(key)
        try:
            meta = _read_meta(d)
            if meta is None:
                return None
            arrays = _map_arrays(d, meta)
            if set(arrays) != set(_ARRAYS):
                return None
        except (OSError, ValueError, json.JSONDecodeError, KeyError):
            return None
        return _graph_of(meta, arrays), meta

    def open(self, key: str) -> EntryHandle | None:
        """Windowed-read handle of an entry, or None on a miss or a
        damaged entry."""
        d = self.entry_dir(key)
        try:
            meta = _read_meta(d)
            if meta is None:
                return None
            handle = EntryHandle(key, d, meta)
            if not set(_ARRAYS) <= set(handle._views):
                return None
        except (OSError, ValueError, json.JSONDecodeError, KeyError):
            return None
        return handle

    def save(self, key: str, graph: Graph, meta: dict) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=self.root, prefix=f".{key}-"))
        try:
            table = []
            with open(tmp / "arrays.bin", "wb") as fh:
                for name in _ARRAYS:
                    arr = np.ascontiguousarray(
                        getattr(graph, name).cpu().numpy())
                    fh.write(b"\0" * (-fh.tell() % _ALIGN))
                    table.append([name, arr.dtype.str, list(arr.shape),
                                  fh.tell(), arr.nbytes])
                    fh.write(arr.tobytes())
            full_meta = {
                "array_table": table,
                **meta, "store_version": STORE_VERSION,
                "n": graph.n, "m_pad": graph.m_pad,
                "num_edges": graph.num_edges,
                "fingerprint": list(graph_fingerprint(graph)),
                "saved_at": time.time(),
            }
            with open(tmp / "meta.json", "w") as fh:
                json.dump(full_meta, fh, indent=1)
            final = self.entry_dir(key)
            try:
                os.replace(tmp, final)          # common case: no entry yet
            except OSError:
                # An entry exists (damaged, or a concurrent ingest's): swap
                # it out atomically and install ours.
                trash = Path(f"{tmp}.old")
                try:
                    os.rename(final, trash)
                except OSError:
                    # a racing writer owns `final` this instant; both hold
                    # the same content, keep theirs
                    shutil.rmtree(tmp, ignore_errors=True)
                    return
                os.replace(tmp, final)
                shutil.rmtree(trash, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    # --- maintenance ---

    def entries(self) -> list[dict]:
        """meta.json of every entry (for ``ingest --list-cache``)."""
        out = []
        if not self.root.is_dir():
            return out
        for d in sorted(self.root.iterdir()):
            mf = d / "meta.json"
            if mf.is_file():
                try:
                    with open(mf) as fh:
                        out.append({"key": d.name, **json.load(fh)})
                except (OSError, json.JSONDecodeError):
                    continue
        return out

    def evict(self, key: str) -> bool:
        d = self.entry_dir(key)
        if d.is_dir():
            shutil.rmtree(d)
            return True
        return False


def _entry_identity(path, fmt: str | None, one_based: bool,
                    n: int | None) -> tuple[str, str]:
    """(resolved format, format token) of a file's store key; shared by
    :func:`load_graph` and :func:`open_graph`, which must agree."""
    fmt = fmt or sniff_format(path)
    if fmt == "mtx" and (one_based or n is not None):
        # .mtx is 1-based with a declared dimension; folding these into
        # the key would fork entries for byte-identical graphs
        raise ValueError("one_based/n only apply to edge-list (snap) "
                         "files; .mtx declares both in its header")
    token = f"{fmt}-base{int(one_based)}-n{n if n is not None else 'auto'}"
    return fmt, token


def load_graph(path, options: PreprocessOptions | None = None, *,
               fmt: str | None = None, one_based: bool = False,
               n: int | None = None, cache: bool = True,
               cache_dir=None, force: bool = False,
               return_report: bool = False):
    """Graph file -> :class:`Graph`, parsed once and stored.

    The first call on a (file content, options) pair parses the file
    (:mod:`repro_torch.io.formats`), runs the §4.1 preprocessing
    (:mod:`repro_torch.io.preprocess`), builds the CSR and stores it in the
    :class:`CsrStore`; every later call maps the stored arrays back.
    ``force=True`` re-ingests over an entry; ``cache=False`` skips the
    store.  The graph lives on the host (a store hit shares the entry's
    pages); the engine moves it to its device.

    Returns the Graph, or ``(Graph, IngestReport)`` with
    ``return_report=True`` (stage times and preprocessing stats; on a
    store hit the stats come from the entry and ``parse_seconds == 0``).
    """
    path = Path(path)
    opts = options or PreprocessOptions()
    fmt, fmt_token = _entry_identity(path, fmt, one_based, n)

    store = CsrStore(cache_dir) if cache else None
    key = ""
    t_hash = 0.0
    if store is not None:
        t0 = time.perf_counter()
        key = CsrStore.key_for(file_content_hash(path), opts, fmt_token)
        t_hash = time.perf_counter() - t0
        if not force:
            t0 = time.perf_counter()
            hit = store.load(key)
            if hit is not None:
                graph, meta = hit
                report = IngestReport(
                    path=str(path), key=key, cache_hit=True,
                    load_seconds=time.perf_counter() - t0,
                    hash_seconds=t_hash,
                    stats=meta.get("stats", {}), meta=meta)
                return (graph, report) if return_report else graph

    t0 = time.perf_counter()
    if fmt == "snap":
        raw = parse_edge_file(path, fmt=fmt, one_based=one_based, n=n)
    else:
        raw = parse_edge_file(path, fmt=fmt)
    t_parse = time.perf_counter() - t0

    t0 = time.perf_counter()
    cleaned, stats = preprocess(raw, opts)
    t_pre = time.perf_counter() - t0

    t0 = time.perf_counter()
    graph = build_graph(cleaned.edges, cleaned.weights, n=cleaned.n)
    t_build = time.perf_counter() - t0

    meta = {"source": str(path), "format": fmt,
            "options": opts.cache_token(), "stats": stats.as_dict(),
            "file_meta": {k: v for k, v in cleaned.meta.items()
                          if isinstance(v, (str, int, float, bool))}}
    t_save = 0.0
    if store is not None:
        t0 = time.perf_counter()
        store.save(key, graph, meta)
        t_save = time.perf_counter() - t0

    report = IngestReport(path=str(path), key=key, cache_hit=False,
                          parse_seconds=t_parse, preprocess_seconds=t_pre,
                          build_seconds=t_build, hash_seconds=t_hash,
                          save_seconds=t_save, stats=stats.as_dict(),
                          meta=meta)
    return (graph, report) if return_report else graph


def open_graph(path, options: PreprocessOptions | None = None, *,
               fmt: str | None = None, one_based: bool = False,
               n: int | None = None, cache_dir=None,
               force: bool = False) -> EntryHandle:
    """Windowed-read handle of a graph file's stored CSR entry.

    Where :func:`load_graph` wraps the full arrays, ``open_graph`` returns
    an :class:`EntryHandle` whose windows are views of the store's map.  A
    file not yet in the store is ingested first (through
    :func:`load_graph`).
    """
    path = Path(path)
    opts = options or PreprocessOptions()
    fmt, fmt_token = _entry_identity(path, fmt, one_based, n)
    store = CsrStore(cache_dir)
    key = CsrStore.key_for(file_content_hash(path), opts, fmt_token)
    if not force:
        handle = store.open(key)
        if handle is not None:
            return handle
    load_graph(path, opts, fmt=fmt,
               **({"one_based": one_based, "n": n} if fmt == "snap" else {}),
               cache_dir=cache_dir, force=force)
    handle = store.open(key)
    if handle is None:
        raise RuntimeError(f"ingest of {path} did not produce store "
                           f"entry {key} (cache_dir misconfigured?)")
    return handle
