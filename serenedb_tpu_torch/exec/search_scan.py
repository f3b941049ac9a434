"""Stub of serenedb_tpu/exec/search_scan.py: index scans are not reachable
through SQL in the port yet (`sql/search_rewrite.py` claims nothing).

The node classes exist so that code walking a plan (the result cache's
source whitelist, `cache/result.py`) can name them; none is ever built.
"""

from __future__ import annotations

from .plan import PlanNode

SCORE_COL = "#score"


class _NotPorted(PlanNode):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}: search through SQL is not ported yet")


class SearchScanNode(_NotPorted):
    pass


class BtreeScanNode(_NotPorted):
    pass


class IvfScanNode(_NotPorted):
    pass


class MaxSimScanNode(_NotPorted):
    pass


class GeoScanNode(_NotPorted):
    pass


class PkScanNode(_NotPorted):
    pass
