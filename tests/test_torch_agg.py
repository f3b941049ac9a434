"""The port's aggregation kernels and expression lowering against the JAX
package, on the CPU.

(a) Every device entry of ops/agg.py gets the same tiles, made from a
numpy seed, in both packages: the reference runs its jitted program on
JAX-CPU, the port its `agg_scan`/`agg_fold` plain versions on CPU
tensors. Integer results must be equal; float sums within rel 1e-5 (the
two add in different orders).

(b) Every WHERE clause and aggregate argument of the reference's
device-parity queries (tests/test_device_agg.py) is bound by each
package's planner and lowered by each package's `compile_expr`; the
reference closure runs on JAX arrays, the port's postfix program through
its plain evaluator, and (value, valid) must be equal. Both must refuse
the same shapes with NotCompilable.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from serenedb_tpu.columnar.column import Batch as RBatch
from serenedb_tpu.columnar.column import Column as RColumn
from serenedb_tpu.columnar.device import to_device_column as r_to_device
from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.exec.device import NotCompilable as RNotCompilable
from serenedb_tpu.exec.device import compile_expr as r_compile
from serenedb_tpu.exec.tables import MemTable as RMemTable
from serenedb_tpu.ops import agg as ragg
from serenedb_tpu.sql import parser as rparser
from serenedb_tpu_torch.carry import memtable_from_reference
from serenedb_tpu_torch.columnar.column import Column
from serenedb_tpu_torch.columnar.device import to_device_column
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.exec.device import NotCompilable, compile_expr
from serenedb_tpu_torch.ops import agg
from serenedb_tpu_torch.ops import agg_kernels as K
from serenedb_tpu_torch.sql import parser as pparser

from test_device_agg import QUERIES, WIDE_QUERIES

FLOAT_RTOL = 1e-5


# -- (a) the ops/agg.py entries -------------------------------------------

def _tiles(rng, n, kind, g=17, nan=False):
    """(codes, mask, vals) numpy tiles of n rows padded to 128 lanes."""
    rows = -(-n // 128)
    codes = np.zeros(rows * 128, np.int32)
    mask = np.zeros(rows * 128, bool)
    codes[:n] = rng.integers(0, g, n)
    mask[:n] = rng.random(n) > 0.1
    if kind == "i32":
        vals = np.zeros(rows * 128, np.int32)
        vals[:n] = rng.integers(-2**31, 2**31, n, dtype=np.int64)
        # the limits themselves, and a group of nothing but them
        vals[:8] = [-2**31, 2**31 - 1, -2**31, 2**31 - 1, -1, 0, 1, -2**31]
        codes[:8] = g - 1
    elif kind == "i32small":
        vals = np.zeros(rows * 128, np.int32)
        vals[:n] = rng.integers(-1000, 1000, n)
    elif kind == "i8":
        vals = np.zeros(rows * 128, np.int8)
        vals[:n] = rng.integers(-128, 128, n)
    else:
        vals = np.zeros(rows * 128, np.float32)
        vals[:n] = rng.normal(size=n) * 100
        vals[:6] = [0.0, -0.0, np.inf, -np.inf, 1e30, -1e-30]
        if nan:
            vals[10:n:97] = np.nan
    return [a.reshape(rows, 128) for a in (codes, mask, vals)]


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


@pytest.mark.parametrize("n", [1, 127, 3000, 20011])
def test_masked_sum_int_partials(n):
    rng = np.random.default_rng(n)
    _c, mask, vals = _tiles(rng, n, "i32")
    (rm, rv), (pm, pv) = _both(mask, vals)
    ref = np.asarray(ragg.masked_sum_int_partials(rv, rm))
    got = agg.masked_sum_int_partials(pv, pm).numpy()
    np.testing.assert_array_equal(got, ref)
    assert agg.masked_sum_int(pv, pm) == ragg.masked_sum_int(rv, rm) == \
        int(vals[mask].astype(np.int64).sum())


@pytest.mark.parametrize("g", [1, 3, 17, 2000])
def test_group_count_scatter(g):
    rng = np.random.default_rng(g)
    codes, mask, _v = _tiles(rng, 5000, "i32small", g)
    (rc, rm), (pc, pm) = _both(codes, mask)
    ref = np.asarray(ragg.group_count_scatter(rc, rm, g))
    got = agg.group_count_scatter(pc, pm, g).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["i32", "i32small", "i8"])
@pytest.mark.parametrize("g", [1, 17])
def test_group_sum_int_limbs_exact(kind, g):
    rng = np.random.default_rng(7)
    codes, mask, vals = _tiles(rng, 7000, kind, g)
    (rc, rm, rv), (pc, pm, pv) = _both(codes, mask, vals)
    ref = np.asarray(ragg.group_sum_int_limbs(rc, rm, rv, g))
    got = agg.group_sum_int_limbs(pc, pm, pv, g).numpy()
    np.testing.assert_array_equal(got, ref)
    expect = np.zeros(g, np.int64)
    np.add.at(expect, codes[mask], vals[mask].astype(np.int64))
    np.testing.assert_array_equal(agg.combine_sum_int_limbs(got), expect)


def test_group_sum_int_limbs_chunked():
    rng = np.random.default_rng(8)
    codes, mask, vals = _tiles(rng, 3000, "i32", 5)
    (rc, rm, rv), (pc, pm, pv) = _both(codes, mask, vals)
    ref = np.asarray(ragg.group_sum_int_limbs_chunked(rc, rm, rv, 5))
    got = agg.group_sum_int_limbs_chunked(pc, pm, pv, 5).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("g", [1, 17, 2000])
def test_group_sum_float(g, nan):
    rng = np.random.default_rng(g)
    codes, mask, vals = _tiles(rng, 9000, "f32", g, nan=nan)
    vals[:6] = 0.0              # keep the infinities out of the sums
    (rc, rm, rv), (pc, pm, pv) = _both(codes, mask, vals)
    ref = np.asarray(ragg.group_sum_float(rc, rm, rv, g))
    got = agg.group_sum_float(pc, pm, pv, g).numpy()
    np.testing.assert_allclose(got, ref, rtol=FLOAT_RTOL, atol=1e-3,
                               equal_nan=True)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("kind", ["i32", "i8", "f32", "f32nan"])
def test_group_min_max(kind, op):
    rng = np.random.default_rng(11)
    g = 40                       # some groups stay empty: identities
    codes, mask, vals = _tiles(rng, 2000, kind.replace("nan", ""), g,
                               nan=kind.endswith("nan"))
    codes[codes == 3] = 4
    (rc, rm, rv), (pc, pm, pv) = _both(codes, mask, vals)
    ref = np.asarray(ragg.group_min_max(rc, rm, rv, g, op))
    got = agg.group_min_max(pc, pm, pv, g, op).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 127, 3000, 20011])
def test_masked_count(n):
    rng = np.random.default_rng(n)
    _c, mask, _v = _tiles(rng, n, "i32")
    (rm,), (pm,) = _both(mask)
    LAUNCHES.reset()
    got = agg.masked_count(pm)
    assert LAUNCHES.get("agg_scan.plain") == 1
    ref = ragg.masked_count(rm)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(ref) == int(mask.sum())


@pytest.mark.parametrize("kind", ["f32", "f32nan", "i32small"])
@pytest.mark.parametrize("n", [1, 3000, 20011])
def test_masked_sum_float(kind, n):
    rng = np.random.default_rng(n)
    _c, mask, vals = _tiles(rng, n, kind.replace("nan", ""),
                            nan=kind.endswith("nan"))
    if kind != "i32small":
        vals[:1, :6] = 0.0          # keep the infinities out of the sum
    (rm, rv), (pm, pv) = _both(mask, vals)
    got = agg.masked_sum_float(pv, pm)
    ref = np.asarray(ragg.masked_sum_float(rv, rm))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), ref, rtol=FLOAT_RTOL, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("kind", ["i32", "i8", "f32", "f32nan", "empty"])
def test_masked_minmax(kind, op):
    rng = np.random.default_rng(5)
    _c, mask, vals = _tiles(rng, 2000, {"empty": "i32"}.get(
        kind, kind.replace("nan", "")), nan=kind.endswith("nan"))
    if kind == "empty":
        mask[:] = False             # the identity
    (rm, rv), (pm, pv) = _both(mask, vals)
    got = agg.masked_minmax(pv, pm, op).numpy()
    ref = np.asarray(ragg.masked_minmax(rv, rm, op))
    assert got.dtype == ref.dtype and got.shape == ref.shape == ()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("g", [1, 3, 17, 1024])
@pytest.mark.parametrize("n", [1, 2048, 5000])
def test_group_count_onehot(g, n):
    """The (chunk, G) f32 partials: every entry equal to the reference's,
    codes past G counting nowhere."""
    rng = np.random.default_rng(g + n)
    codes, mask, _v = _tiles(rng, n, "i32small", g)
    codes[0, :4] = [g, g + 5, -1, 0]
    (rc, rm), (pc, pm) = _both(codes, mask)
    LAUNCHES.reset()
    got = agg.group_count_onehot(pc, pm, g).numpy()
    assert LAUNCHES.get("agg_scan.plain") == 1
    ref = np.asarray(ragg.group_count_onehot(rc, rm, g))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("g", [3, 2000])    # chunk partials, scatter
def test_group_count(g):
    """tests/test_ops_agg.py's `test_group_count_paths` inputs."""
    rng = np.random.default_rng(1)
    codes_np = rng.integers(0, g, size=4000).astype(np.int64)
    rdc = r_to_device(RColumn.from_numpy(codes_np))
    pdc = to_device_column(Column.from_numpy(codes_np), device="cpu")
    ref = ragg.group_count(rdc.decode(rdc.data), rdc.mask, g)
    pcodes = K.decode_plain(*K.col_kind(pdc), pdc.data).view(pdc.data.shape)
    got = agg.group_count(pcodes, pdc.mask, g)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.bincount(codes_np, minlength=g))


def test_entries_launch_the_scan_kernel_plain_version():
    rng = np.random.default_rng(0)
    codes, mask, vals = _tiles(rng, 500, "f32", 3)
    _, (pc, pm, pv) = _both(codes, mask, vals)
    LAUNCHES.reset()
    agg.group_sum_float(pc, pm, pv, 3)
    assert LAUNCHES.get("agg_scan.plain") == 1
    assert LAUNCHES.get("agg_fold.plain") == 1
    assert LAUNCHES.get("agg_scan") == 0


def test_float_partition_keeps_the_plane_in_budget():
    for n, g in [(0, 1), (1, 1), (2_000_000, 1), (2_000_000, 1 << 21),
                 (10_000_000, 200)]:
        p, rpw = K.partition(n, g, True)
        assert rpw % 32 == 0 and p * rpw >= n and (p - 1) * rpw < max(n, 1)
        assert p * g * 4 <= max(K.FLOAT_PLANE_BYTES, g * 4)
        assert p <= K.MAX_WARPS


# -- (b) compile_expr ------------------------------------------------------

EXTRA_PREDS = [
    "f * 2.5 > k", "CAST(f AS INT) > 0", "CAST(k AS DOUBLE) < 1.5",
    "nv IS NOT NULL OR k < 3", "NOT (g < 'beta')", "'beta' < g",
    "g <= 'beta'", "g > 'beta'", "g <> 'zzz'", "k - 100 < -50",
    "t * t > 10", "t + t < 0", "b AND k > 3", "b = true", "NOT b",
    "CAST(s AS INT) <> 0", "s > 1.0", "s = s", "s * 2 < 3",
    "nv + k > 20 AND (f < 0 OR nv IS NULL)", "k * 100000 * 100000 > 0",
]
NOT_COMPILABLE = ["k / 2 > 1", "k % 3 = 0", "v > 3000000000", "g = g",
                  "abs(k) > 1", "g || 'x' = 'ax'"]


def _h_columns():
    rng = np.random.default_rng(7)
    n = 600
    s = rng.normal(size=n) * 1e9
    s[:9] = [np.nan, np.inf, -np.inf, -0.0, 0.5, -0.5, 2.5, -2.5, 3e9]
    cols = {
        "k": RColumn.from_numpy(rng.integers(0, 50, n).astype(np.int32)),
        "g": RColumn.from_numpy(rng.choice(["alpha", "beta", "gamma",
                                            "delta"], n)),
        "v": RColumn.from_numpy(rng.integers(-10**6, 10**6, n)),
        "f": RColumn.from_numpy(rng.normal(size=n)),
        "t": RColumn.from_numpy(rng.integers(-128, 128, n).astype(np.int8)),
        "b": RColumn.from_numpy(rng.random(n) > 0.5),
        "s": RColumn.from_numpy(s),
    }
    ks = cols["k"].data
    cols["nv"] = RColumn(cols["k"].type, ks.copy(), rng.random(n) > 0.1)
    return cols


@pytest.fixture(scope="module")
def planners():
    cols = _h_columns()
    rdb = RDatabase()
    rdb.schemas["main"].tables["h"] = RMemTable(
        "h", RBatch.from_pydict(cols))
    pdb = Database(device="cpu")
    pdb.schemas["main"].tables["h"] = memtable_from_reference(
        "h", {k: (c.data, c.validity, c.dictionary) for k, c in cols.items()})
    rng = np.random.default_rng(11)
    wide = {"uid": RColumn.from_numpy(rng.integers(0, 1 << 62, 500)),
            "region": RColumn.from_numpy(
                rng.integers(0, 200, 500).astype(np.int32)),
            "w": RColumn.from_numpy(rng.integers(-(1 << 40), 1 << 40, 500)),
            "x": RColumn.from_numpy(rng.integers(0, 1000, 500)
                                    .astype(np.int32))}
    rdb.schemas["main"].tables["hits2"] = RMemTable(
        "hits2", RBatch.from_pydict(wide))
    pdb.schemas["main"].tables["hits2"] = memtable_from_reference(
        "hits2", {k: (c.data, c.validity, c.dictionary)
                  for k, c in wide.items()})
    return rdb.connect(), pdb.connect()


def _exprs(conn, mod_parser, sql):
    """(scan, predicates, aggregate arguments) of a single-table
    aggregate query, bound by that package."""
    plan = conn._plan(mod_parser.parse_one(sql), [])
    node = plan
    while type(node).__name__ != "AggregateNode":
        node = node.child
    preds, child = [], node.child
    while type(child).__name__ == "FilterNode":
        preds.append(child.pred)
        child = child.child
    if child.filter is not None:
        preds.append(child.filter)
    return child, preds, [s.arg for s in node.aggs if s.arg is not None]


def _dictionaries(scan):
    out = {}
    for i, name in enumerate(scan.columns):
        col = scan.provider.host_column(name)
        if scan.types[i].is_string and col.dictionary is not None:
            out[i] = col.dictionary
    return out


def _ref_eval(scan, e):
    ce = r_compile(e, scan.types, _dictionaries(scan))
    env = []
    for i in ce.inputs:
        dc = r_to_device(scan.provider.host_column(scan.columns[i]))
        env.append((dc.decode(dc.data), dc.mask))
    n = env[0][0].size if env else 1
    v, ok = ce.fn(env)
    return (np.broadcast_to(np.asarray(v), (n,)) if np.ndim(v) == 0
            else np.asarray(v).reshape(-1),
            np.broadcast_to(np.asarray(ok), (n,)) if np.ndim(ok) == 0
            else np.asarray(ok).reshape(-1))


def _port_eval(scan, e):
    ce = compile_expr(e, scan.types, _dictionaries(scan))
    env = []
    for i in ce.inputs:
        dc = to_device_column(scan.provider.host_column(scan.columns[i]),
                              device="cpu")
        kind, off = K.col_kind(dc)
        env.append((K.decode_plain(kind, off, dc.data.reshape(-1)),
                    dc.mask.reshape(-1)))
    n = env[0][0].shape[0] if env else 1
    v, ok = K.eval_plain(ce.ops, env, n)
    return v.numpy(), ok.numpy()


def _sql_for(pred):
    return f"SELECT count(*) FROM h WHERE {pred}"


EXPR_QUERIES = QUERIES + WIDE_QUERIES + [_sql_for(p) for p in EXTRA_PREDS] \
    + ["SELECT sum(t * t), min(s), max(s * 2), avg(CAST(t AS DOUBLE)) "
       "FROM h WHERE b", "SELECT sum(k + nv), count(b) FROM h"]


@pytest.mark.parametrize("q", EXPR_QUERIES)
def test_compile_expr_matches_reference(planners, q):
    rconn, pconn = planners
    rscan, rpreds, rargs = _exprs(rconn, rparser, q)
    pscan, ppreds, pargs = _exprs(pconn, pparser, q)
    assert len(rpreds) == len(ppreds) and len(rargs) == len(pargs)
    for re_, pe in zip(rpreds + rargs, ppreds + pargs):
        try:
            rv, rok = _ref_eval(rscan, re_)
        except RNotCompilable:
            with pytest.raises(NotCompilable):
                _port_eval(pscan, pe)
            continue
        pv, pok = _port_eval(pscan, pe)
        np.testing.assert_array_equal(pok, rok, err_msg=q)
        np.testing.assert_array_equal(
            pv.astype(np.float64), rv.astype(np.float64), err_msg=q)


@pytest.mark.parametrize("pred", NOT_COMPILABLE)
def test_not_compilable_where_the_reference_declines(planners, pred):
    rconn, pconn = planners
    rscan, (re_,), _ = _exprs(rconn, rparser, _sql_for(pred))
    pscan, (pe,), _ = _exprs(pconn, pparser, _sql_for(pred))
    with pytest.raises(RNotCompilable):
        _ref_eval(rscan, re_)
    with pytest.raises(NotCompilable):
        _port_eval(pscan, pe)


def test_deep_programs_decline_and_stay_right(planners):
    """A program deeper than the kernel's stack is refused (narrower than
    the reference) and the query runs on the host with the same rows."""
    rconn, pconn = planners
    deep = "k + (k + (k + (k + (k + (k + (k + (k + (k + 1)))))))) > 40"
    pscan, (pe,), _ = _exprs(pconn, pparser, _sql_for(deep))
    with pytest.raises(NotCompilable, match="stack"):
        _port_eval(pscan, pe)
    pconn.execute("SET serene_device = 'gpu'")
    got = pconn.execute(_sql_for(deep)).rows()
    rconn.execute("SET serene_device = 'cpu'")
    assert got == rconn.execute(_sql_for(deep)).rows()
