"""The control of each configuration's comparison comes out as not
correct: the reference in the precision below the stated one (int32 sums
and float32 averages for `hits`, bfloat16 scores for BM25), put in the
program's place and judged by the same comparison, at sizes a test run
holds. `python3 -m portbench.control` runs the same at the cells' own
sizes on the card."""

import pytest

from portbench.control import control

SIZES = {
    # 2M rows: ResolutionWidth's sums pass 2**31, as they do at 100M
    "hits_100m.agg_mix": {"rows": 2_000_000},
    "msmarco_1m.search_batched": {"passages": 20_000, "vocabulary": 20_000,
                                  "queries": 300},
}


@pytest.mark.parametrize("workload", sorted(SIZES))
@pytest.mark.parametrize("seed", [11, 2**31 + 7])
def test_the_control_is_not_correct(workload, seed):
    out = control(workload, seed, "cpu", SIZES[workload])
    assert not out["correct"], out


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_the_control_at_the_cells_size_on_the_card(workload, card):
    out = control(workload, 11, card)
    assert not out["correct"], out
