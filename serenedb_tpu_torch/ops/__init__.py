"""Device kernels of the port: hand-written CUDA for Hopper (`csrc/`),
their wrappers and plain PyTorch versions (`bm25_kernels.py`,
`agg_kernels.py`), the BM25 host planning and dispatch (`bm25.py`), and
the aggregation entries (`agg.py`)."""
