"""serenedb_tpu_torch — the PyTorch/CUDA port of serenedb_tpu for NVIDIA Hopper.

Each module keeps the path and names of its counterpart in `serenedb_tpu`,
so a reader finds one from the other. Host code (analysis, query parsing,
index build, WAND planning, the SQL front end and host executor) comes
over as copies that change only what their first docstring line says;
device work runs as hand-written CUDA kernels for `sm_90a` (`ops/csrc/`),
each with a plain PyTorch version beside it (`ops/bm25_kernels.py`,
`ops/agg_kernels.py`) that the CPU tests hold against the JAX package.

This package imports `torch` and numpy, never `jax` and nothing of
`serenedb_tpu`. Entry points run on `cuda:0` unless the caller passes
`device="cpu"`; with no card and no explicit CPU request they raise
(`device.resolve_device`).

Ported so far: BM25/TFIDF/LM top-k search through
`search.searcher.SegmentSearcher.topk_batch` (dense and packed regimes),
and SQL analytics through `engine.Database(device=...).connect().execute`
(single-table scan-filter-aggregate on the `agg_scan`/`agg_fold`
kernels; the device tiers not ported yet are stubs that decline).
"""

__version__ = "0.1.0"
