"""The published peaks of the card the benchmark runs on (NVIDIA H100
SXM data sheet, at its 700 W power limit)."""

#: device memory bytes per second
HBM_BYTES_PER_S = 3.35e12
