"""Copied from serenedb_tpu/exec/filesource.py.

Zero-ETL file sources: read_parquet / read_csv table functions with
glob expansion and remote-URL fetch.

Reference analog: server/connector/index_source_view_file.cpp (file-backed
views dispatching read_parquet over member files) + its http/S3 readers.
Remote fetch is a straight HTTP GET with an on-disk content cache; in a
no-egress environment it surfaces SQLSTATE 58030 rather than hanging.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
import tempfile

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column, concat_batches
from .tables import MemTable, ParquetTable, TableProvider

_FETCH_CACHE_DIR = os.path.join(tempfile.gettempdir(),
                                "serenedb_fetch_cache")


def is_remote(path: str) -> bool:
    return path.startswith(("http://", "https://", "s3://"))


def resolve_path(path: str) -> str:
    """Local path for a possibly-remote file (download-through cache)."""
    if not is_remote(path):
        return path
    if path.startswith("s3://"):
        # anonymous S3 over the HTTP endpoint (the reference's S3 reader
        # with credentials is config surface we don't have secrets for yet)
        bucket, _, key = path[5:].partition("/")
        path = f"https://{bucket}.s3.amazonaws.com/{key}"
    os.makedirs(_FETCH_CACHE_DIR, exist_ok=True)
    name = hashlib.sha256(path.encode()).hexdigest()[:32] + \
        os.path.splitext(path)[1]
    local = os.path.join(_FETCH_CACHE_DIR, name)
    if os.path.exists(local):
        return local
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(path, timeout=60) as resp:
            data = resp.read()
    except (urllib.error.URLError, OSError) as e:
        raise errors.SqlError(
            "58030", f"remote file fetch failed for {path}: {e}")
    tmp = local + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, local)
    return local


def expand_glob(path: str) -> list[str]:
    if is_remote(path):
        return [path]
    if any(ch in path for ch in "*?["):
        matches = sorted(_glob.glob(path))
        if not matches:
            raise errors.SqlError("58P01",
                                  f"no files match {path!r}")
        return matches
    if not os.path.exists(path):
        raise errors.SqlError(
            "58P01", f'could not open file "{path}": '
                     "No such file or directory")
    return [path]


def parquet_source(db, path: str, pinned: bool = False) -> TableProvider:
    """read_parquet over a path, glob, or URL. Single local files reuse
    the provider cache (HBM column cache + compiled programs); multi-file
    globs materialize a unioned table cached by (paths, mtimes).

    pinned=True: iceberg-style snapshot pinning (reference:
    index_source_view_file.cpp pinned snapshots) — the FIRST resolution
    freezes the file list and contents; files added, changed or removed
    later never alter results. Pins live for the Database's lifetime
    (a fresh Database re-resolves)."""
    from ..columnar.arrow_io import require_pyarrow
    require_pyarrow()
    if pinned:
        with db.lock:
            pins = getattr(db, "_pinned_snapshots", None)
            if pins is None:
                pins = db._pinned_snapshots = {}
            hit = pins.get(("parquet", path))
        if hit is not None:
            return hit
        provider = parquet_source(db, path, pinned=False)
        # materialize NOW: later mtime/file changes must not show through
        frozen = MemTable(os.path.basename(path),
                          provider.full_batch())
        with db.lock:
            # two concurrent first resolutions: FIRST pin wins, both
            # serve the same snapshot thereafter
            return pins.setdefault(("parquet", path), frozen)
    paths = [resolve_path(p) for p in expand_glob(path)]
    if len(paths) == 1:
        with db.lock:
            p = db._parquet_cache.get(paths[0])
            if p is None:
                p = db._parquet_cache[paths[0]] = ParquetTable(paths[0])
        return p
    key = tuple((p, os.path.getmtime(p)) for p in paths)
    cache = getattr(db, "_fileview_cache", None)
    if cache is None:
        cache = db._fileview_cache = {}
    hit = cache.get(("parquet", key))
    if hit is not None:
        return hit
    batches = [ParquetTable(p).full_batch() for p in paths]
    names = batches[0].names
    types0 = [c.type for c in batches[0].columns]
    for i, b in enumerate(batches[1:], 1):
        if list(b.names) != list(names) or \
                [c.type for c in b.columns] != types0:
            raise errors.SqlError(
                "42P16", f"parquet files disagree on schema: "
                         f"{paths[0]} vs {paths[i]}")
    t = MemTable(os.path.basename(path), concat_batches(batches))
    if len(cache) > 32:
        cache.clear()
    cache[("parquet", key)] = t
    return t


def _infer_column(vals: list) -> Column:
    """int64 → float64 → text inference over csv strings ('' = NULL)."""
    live = [v for v in vals if v != ""]

    def try_cast(cast, typ):
        out = []
        for v in vals:
            if v == "":
                out.append(None)
            else:
                out.append(cast(v))
        return Column.from_pylist(out, typ)
    try:
        return try_cast(int, dt.BIGINT)
    except ValueError:
        pass
    try:
        return try_cast(float, dt.DOUBLE)
    except ValueError:
        pass
    if live and all(v.lower() in ("true", "false", "t", "f") for v in live):
        return Column.from_pylist(
            [None if v == "" else v.lower() in ("true", "t")
             for v in vals], dt.BOOL)
    return Column.from_pylist([None if v == "" else v for v in vals],
                              dt.VARCHAR)


def csv_source(db, path: str, header=None, delimiter=",") -> TableProvider:
    """read_csv with type inference; header auto-detected unless given
    (a first row whose cells don't parse under the inferred body types)."""
    import csv as _csv
    paths = [resolve_path(p) for p in expand_glob(path)]
    key = tuple((p, os.path.getmtime(p)) for p in paths) + \
        (header, delimiter)
    cache = getattr(db, "_fileview_cache", None)
    if cache is None:
        cache = db._fileview_cache = {}
    hit = cache.get(("csv", key))
    if hit is not None:
        return hit
    all_rows: list[list[str]] = []
    first_header: list[str] | None = None
    for pi, p in enumerate(paths):
        try:
            with open(p, newline="") as f:
                rows = list(_csv.reader(f, delimiter=delimiter))
        except OSError as e:
            raise errors.SqlError("58030", f"cannot read {p}: {e}")
        if not rows:
            continue
        use_header = header
        if use_header is None:
            # auto-detect: a first row that is all-text while any body
            # cell in the same column parses numeric ⇒ header
            use_header = _looks_like_header(rows)
        if use_header:
            if first_header is None:
                first_header = [c.strip() for c in rows[0]]
            rows = rows[1:]
        all_rows.extend(rows)
    ncols = max((len(r) for r in all_rows), default=0)
    if first_header is not None:
        # header-only files still expose their declared columns
        ncols = max(ncols, len(first_header))
    if first_header is None:
        first_header = [f"column{i}" for i in range(ncols)]
    if len(first_header) < ncols:
        first_header += [f"column{i}"
                         for i in range(len(first_header), ncols)]
    cols = []
    for ci in range(ncols):
        vals = [(r[ci] if ci < len(r) else "") for r in all_rows]
        cols.append(_infer_column(vals))
    t = MemTable(os.path.basename(path),
                 Batch(first_header[:ncols], cols))
    if len(cache) > 32:
        cache.clear()
    cache[("csv", key)] = t
    return t


def _looks_like_header(rows: list[list[str]]) -> bool:
    if len(rows) < 2:
        return False
    head, body = rows[0], rows[1:]

    def numericish(v: str) -> bool:
        try:
            float(v)
            return True
        except ValueError:
            return False
    for ci in range(len(head)):
        if numericish(head[ci]):
            return False        # numeric header cell ⇒ data row
        if any(ci < len(r) and r[ci] != "" and numericish(r[ci])
               for r in body):
            return True         # text over a numeric column ⇒ header
    return False
