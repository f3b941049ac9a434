"""Run one cell of the benchmark of serenedb_tpu_torch.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or `python -m portbench.run ...` from the repository's root). Prints one
JSON line last on standard output, and the numbers compared for
`correct` beside their limits last on standard error. Exits non-zero,
with no result, without a CUDA device.
"""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
