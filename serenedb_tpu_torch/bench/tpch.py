"""TPC-H tables made from a seed, for the card smoke script and the tests.

    from serenedb_tpu_torch.bench.tpch import tpch_tables
    tables = tpch_tables(1_500_000)   # SF1 cardinalities
"""

from __future__ import annotations

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.column import Column


def _days(iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01"))
               .astype(np.int64))


def tpch_tables(n_orders: int = 1_500_000, seed: int = 0) -> dict:
    """customer, orders and lineitem at TPC-H cardinalities, after dbgen's
    rules (TPC-H v3, 4.2.3): n_orders / 10 customers with 5 market
    segments; sparse order keys (the first 8 of every 32), order dates
    uniform over 1992-01-01 .. 1998-08-02, customers drawn from the keys
    not divisible by 3 (a third never order), 5 priorities; 1-7 lines an
    order, supplier keys uniform over 1..10,000, quantities 1..50,
    extended price = quantity x the part's retail price in cents, ship
    date = order date + 1..121, return flag R/A once received by
    1995-06-17 else N, line status O after it else F; total price = the
    lines' price with tax and discount, in cents."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_orders, dtype=np.int64)
    okey = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    odate = rng.integers(_days("1992-01-01"), _days("1998-08-02") + 1,
                         n_orders).astype(np.int32)
    prio = np.asarray(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                       "5-LOW"], dtype=object)[rng.integers(0, 5, n_orders)]
    nlines = rng.integers(1, 8, n_orders)
    n = int(nlines.sum())
    oidx = np.repeat(np.arange(n_orders), nlines)
    partkey = rng.integers(1, 200_001, n)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    qty = rng.integers(1, 51, n).astype(np.int32)
    ext = (qty * retail).astype(np.int32)
    disc = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    ship = (odate[oidx] + rng.integers(1, 122, n)).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n)
    current = _days("1995-06-17")
    rflag = np.where(receipt <= current,
                     np.where(rng.random(n) < 0.5, "R", "A"), "N")
    lstatus = np.where(ship > current, "O", "F")
    total = np.bincount(oidx, weights=ext * (100 + tax) * (100 - disc) /
                        10000.0, minlength=n_orders)
    n_cust = n_orders // 10
    ck = rng.integers(1, n_cust + 1, 2 * n_orders)
    ck = ck[ck % 3 != 0][:n_orders].astype(np.int32)
    seg = np.asarray(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                      "MACHINERY"], dtype=object)
    date = lambda a: Column(dt.DATE, a)  # noqa: E731
    num = Column.from_numpy
    return {
        "customer": {
            "c_custkey": num(np.arange(1, n_cust + 1, dtype=np.int32)),
            "c_mktsegment": num(seg[rng.integers(0, 5, n_cust)])},
        "orders": {
            "o_orderkey": num(okey), "o_custkey": num(ck),
            "o_orderdate": date(odate),
            "o_totalprice": num(np.round(total).astype(np.int32)),
            "o_orderpriority": num(prio)},
        "lineitem": {
            "l_orderkey": num(okey[oidx]),
            "l_suppkey": num(rng.integers(1, 10_001, n).astype(np.int32)),
            "l_quantity": num(qty), "l_extendedprice": num(ext),
            "l_shipdate": date(ship),
            "l_returnflag": num(rflag.astype(object)),
            "l_linestatus": num(lstatus.astype(object))},
    }
