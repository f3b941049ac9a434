"""Copied from serenedb_tpu/native/__init__.py (the library builds into
serenedb_tpu_torch/_build/ under a name hashed from its source and flags,
and `BUILDS` counts which path built each field index).

Native (C++) runtime components, loaded via ctypes.

The compute path is CUDA on the card; the CPU-bound runtime pieces mirror
the reference's native implementation — currently the inverted-index
builder (tokenize + postings in one pass). Compiled on first use with g++
into _build/; everything degrades gracefully to the Python implementations
when no toolchain is available, and `BUILDS` shows which one ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..device import LaunchLedger
from ..utils import log

_lock = threading.Lock()
_lib = None
_tried = False

#: field indexes built per path, "native" (this library) or "python"
#: (search.segment's builder), and the native builds' wall time in
#: "native_ns": a run can show that its indexes took the native path
BUILDS = LaunchLedger()

_SRC = os.path.join(os.path.dirname(__file__), "indexer.cpp")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def library_path() -> str:
    """Where the library builds: named by a hash of the source and the
    flags, so a changed source never loads a stale build."""
    import hashlib
    h = hashlib.sha256(open(_SRC, "rb").read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_build_dir(),
                        f"libsdbnative-{h.hexdigest()[:16]}.so")


def load() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not os.path.exists(so):
                # a private temporary name: processes that build at once
                # each rename a whole library into place
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = ["g++", *_FLAGS, "-o", tmp, _SRC]
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError) as e:
            log.warn("native", f"native indexer unavailable: {e}")
            return None
        lib.sdb_build_index.restype = ctypes.c_void_p
        lib.sdb_build_index.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int64),
                                        ctypes.c_int64]
        lib.sdb_build_index_mt.restype = ctypes.c_void_p
        lib.sdb_build_index_mt.argtypes = [ctypes.c_char_p,
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.c_int64, ctypes.c_int32]
        for name in ("sdb_num_terms", "sdb_postings_len",
                     "sdb_positions_len", "sdb_terms_bytes",
                     "sdb_total_tokens"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.sdb_fill.restype = None
        lib.sdb_fill.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int64)] + \
            [ctypes.POINTER(ctypes.c_int32)] + \
            [ctypes.POINTER(ctypes.c_int64)] + \
            [ctypes.POINTER(ctypes.c_int32)] * 2 + \
            [ctypes.POINTER(ctypes.c_int64)] + \
            [ctypes.POINTER(ctypes.c_int32)] * 2
        lib.sdb_free.restype = None
        lib.sdb_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def ingest_threads() -> int:
    """Parallel-ingest width: SDB_INGEST_THREADS overrides, else all
    cores (the reference's ParallelSink uses the scheduler's thread
    count the same way)."""
    env = os.environ.get("SDB_INGEST_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, os.cpu_count() or 1)


def build_field_index_native(texts,
                             n_threads: Optional[int] = None
                             ) -> Optional["FieldIndex"]:
    """Build a FieldIndex with the C++ one-pass indexer (multithreaded —
    the ctypes call drops the GIL and the shards tokenize on std::threads).
    Returns None when the native library is unavailable (caller falls back
    to Python)."""
    lib = load()
    if lib is None:
        return None
    import time
    t0 = time.perf_counter_ns()
    from ..search.segment import FieldIndex

    parts = []
    doc_offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    total = 0
    for i, t in enumerate(texts):
        if t:
            b = t.encode("utf-8")
            parts.append(b)
            total += len(b)
        doc_offsets[i + 1] = total
    buf = b"".join(parts)

    handle = lib.sdb_build_index_mt(
        buf, doc_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts),
        ingest_threads() if n_threads is None else max(1, int(n_threads)))
    try:
        t_count = lib.sdb_num_terms(handle)
        p_len = lib.sdb_postings_len(handle)
        pp_len = lib.sdb_positions_len(handle)
        t_bytes = lib.sdb_terms_bytes(handle)
        total_tokens = lib.sdb_total_tokens(handle)

        terms_buf = ctypes.create_string_buffer(max(int(t_bytes), 1))
        term_offsets = np.zeros(t_count + 1, dtype=np.int64)
        doc_freq = np.zeros(max(t_count, 1), dtype=np.int32)
        offsets = np.zeros(t_count + 1, dtype=np.int64)
        post_docs = np.zeros(max(p_len, 1), dtype=np.int32)
        post_tfs = np.zeros(max(p_len, 1), dtype=np.int32)
        pos_offsets = np.zeros(p_len + 1, dtype=np.int64)
        positions = np.zeros(max(pp_len, 1), dtype=np.int32)
        norms = np.zeros(max(len(texts), 1), dtype=np.int32)

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        def p32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        lib.sdb_fill(handle, terms_buf, p64(term_offsets), p32(doc_freq),
                     p64(offsets), p32(post_docs), p32(post_tfs),
                     p64(pos_offsets), p32(positions), p32(norms))
    finally:
        lib.sdb_free(handle)

    raw = terms_buf.raw
    terms = np.asarray(
        [raw[term_offsets[i]:term_offsets[i + 1]].decode("utf-8")
         for i in range(t_count)], dtype=object)
    BUILDS.bump("native")
    BUILDS.bump("native_ns", time.perf_counter_ns() - t0)
    return FieldIndex(
        terms=terms,
        doc_freq=doc_freq[:t_count],
        offsets=offsets,
        post_docs=post_docs[:p_len],
        post_tfs=post_tfs[:p_len],
        pos_offsets=pos_offsets,
        positions=positions[:pp_len],
        norms=norms[:len(texts)],
        block_max_tf=np.empty(0, dtype=np.int32),
        block_offsets=np.zeros(t_count + 1, dtype=np.int64),
        total_tokens=int(total_tokens),
    )
