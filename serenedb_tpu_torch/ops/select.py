"""Buffer sizes of the selection levels of `csrc/select.cuh`.

`sel::levels` takes each row's n keys (sorted runs of `run` keys; 1:
unsorted) down to its K smallest, alternating between two buffers. The
wrappers of `ivf_probe` and `maxsim` size those buffers from
`scratch`, which follows the loop of `sel::level_caps`; the kernel side
refuses a level that would not fit, so a disagreement raises instead of
writing past a buffer, and a card test (`tests/test_torch_gpu.py`) holds
`scratch` against the C++ sizes (`vector.cu` `select_cap`).
"""

from __future__ import annotations

#: keys one block sorts in shared memory
TMAX = 8192


def tile_for(keep: int, floor: int) -> int:
    """The tile of a level that keeps `keep` keys: a power of two >= 2 *
    keep from `floor`, at most TMAX."""
    t = floor
    while t < 2 * keep and t < TMAX:
        t <<= 1
    return t


def level_sizes(n: int, run: int, keep: int, floor: int) -> list[int]:
    """Keys a row holds before the first level and after each one."""
    tile = tile_for(keep, floor)
    kt = min(keep, tile)
    sizes = [n]
    while n != keep or run < keep:
        if 2 * keep <= tile or run < kt:
            n, run = -(-n // tile) * kt, kt
        else:
            run_out = min(2 * run, keep)
            n, run = -(-(n // run) // 2) * run_out, run_out
        sizes.append(n)
    return sizes


def scratch(rows: int, n: int, run: int, keep: int,
            floor: int) -> tuple[int, int]:
    """Keys the two buffers must hold: the first holds the input and every
    even level, the second every odd level (at least 1 key each)."""
    sizes = level_sizes(n, run, keep, floor)
    return (rows * max(sizes[0::2]), rows * max(max(sizes[1::2], default=0),
                                                1))
