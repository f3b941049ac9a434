"""Stub of serenedb_tpu/search/posting_pool.py: the paged posting pool
(K9) is not ported yet.

The reference reaches the pool only from its ragged path, which it takes
on its host backend alone (searcher.py `_host_backend`); the port's
searchers score on the plane path, so no page is ever resident.
`note_publication` therefore has nothing to label, and the
`sdb_posting_pool` relation raises FEATURE_NOT_SUPPORTED.
"""

from __future__ import annotations

from .. import errors


def note_publication(searcher, provider, pin) -> None:
    """The reference stamps the scan's publication onto resident pages;
    the port holds none."""


class _PostingPool:
    def snapshot(self) -> list:
        raise errors.unsupported(
            "sdb_posting_pool: the posting pool is not ported yet")


POOL = _PostingPool()
