"""Warm QPS of the packed search cell (`chip_smoke.py` phase 4) for one
checkout, on one card.

Runs `chip_smoke.phase_packed` of the checkout at ROOT (default: this
one): the 8M-doc `bm25_8m` corpus, 96 queries, top-10, then its ragged
leg with the posting pool on. The last line is one JSON object: the
phase's warm QPS, and the ragged leg's ragged and planes QPS.

To compare two checkouts on one card, unpack the other with `git
archive` into a git-ignored directory of this one and run both in
alternating pairs in one call, each run its own process:

    for r in OTHER . . OTHER OTHER . ...; do
        python3 scripts/packed_qps.py $r | tail -1; done
"""

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from serenedb_tpu_torch.utils.config import REGISTRY as settings  # noqa: E402


def main() -> None:
    settings.set_global("serene_device_cache_mb", cs.DEVICE_CACHE_MB)
    packed = cs.phase_packed(torch.device("cuda", 0))
    print(json.dumps({"root": ROOT, "packed_qps": packed["qps"],
                      "ragged_qps": packed["ragged"]["qps"],
                      "plane_qps": packed["ragged"]["plane_qps"]}),
          flush=True)


if __name__ == "__main__":
    main()
