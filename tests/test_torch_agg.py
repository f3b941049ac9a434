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
    """On CPU tensors the entry runs the plain versions; the f32 sums'
    plane folds only where it has more than one row (more than one
    block of rows): a one-row plane is already the sums."""
    rng = np.random.default_rng(0)
    for n, folds in ((500, 0), (K.SCAN_BLOCK_ROWS + 500, 1)):
        codes, mask, vals = _tiles(rng, n, "f32", 3)
        _, (pc, pm, pv) = _both(codes, mask, vals)
        LAUNCHES.reset()
        agg.group_sum_float(pc, pm, pv, 3)
        assert LAUNCHES.get("agg_scan.plain") == 1
        assert LAUNCHES.get("agg_fold.plain") == folds
        assert LAUNCHES.get("agg_scan") == 0


def _spec(G, kinds):
    return K.ScanSpec([K.COL_F32], [0], factorized=True, G=G,
                      aggs=[K.ScanAgg(k, ((K.OP_COL, 0, 0),))
                            for k in kinds])


def _small_limit(kinds):
    """The largest G the SMALL regime takes for these aggregates."""
    per_group = K.small_cells_bytes(_spec(1, kinds))
    return K.SMALL_SMEM_BYTES // per_group


def test_float_partition_keeps_the_plane_in_budget():
    """The split: whole blocks of 256-row steps that cover the rows once,
    at most MAX_BLOCKS of them; SMALL only where a block's cells fit its
    shared-memory budget; the f32 plane one row per block there and in
    SCALAR, and no plane (one row: the sums) at large G."""
    f = [K.AGG_SUM_F, K.AGG_SUM_F, K.AGG_MIN_F, K.AGG_MAX_F]
    lim = _small_limit(f)
    for n, g in [(0, 1), (1, 1), (2_000_000, 1), (2_000_000, 1 << 21),
                 (10_000_000, 200), (2_097_152, lim), (2_097_152, lim + 1),
                 (100_000_000, 201), (2_097_152, 1_000_001)]:
        sp = K.split(_spec(g, f), n)
        assert sp.rows_per_block % K.BLOCK_ROWS == 0
        assert sp.blocks * sp.rows_per_block >= n
        assert (sp.blocks - 1) * sp.rows_per_block < max(n, 1)
        assert 1 <= sp.blocks <= K.MAX_BLOCKS
        if g == 1:
            assert sp.regime == K.REGIME_SCALAR and sp.plane_rows == \
                sp.blocks
        elif g <= lim:
            assert sp.regime == K.REGIME_SMALL and sp.plane_rows == \
                sp.blocks
            assert sp.smem == K.small_cells_bytes(_spec(g, f)) <= \
                K.SMALL_SMEM_BYTES
        else:
            assert sp.regime == K.REGIME_SORT and sp.plane_rows == 1
            ik = [K.AGG_MIN_I, K.AGG_SUM_I]
            ints = K.split(_spec(g, ik), n)
            assert ints.regime == (K.REGIME_SMALL if g <= _small_limit(ik)
                                   else K.REGIME_LARGE)
        assert sp.plane_rows * g * 4 <= max(K.MAX_BLOCKS * lim * 4, g * 4)
        # the split reads the spec and the row count only
        assert K.split(_spec(g, f), n) == sp


@pytest.mark.parametrize("n", [1, 255, 4096, 4097, 40_000])
@pytest.mark.parametrize("g", [1, 7, 100_003])
def test_split_covers_every_row_once(n, g):
    """The kernel's rows — block b, step s, thread t on row b·RPB +
    256·s + t while inside the block's range — cover [0, n) once."""
    sp = K.split(_spec(g, [K.AGG_SUM_F]), n)
    seen = []
    for b in range(sp.blocks):
        r0 = b * sp.rows_per_block
        r1 = min(r0 + sp.rows_per_block, n)
        for base in range(r0, r1, K.BLOCK_ROWS):
            seen.extend(r for r in range(base, base + K.BLOCK_ROWS)
                        if r < r1)
    assert sorted(seen) == list(range(n)) and len(seen) == n


def _float_data(rng, n, g):
    """(codes, mask, vals) tiles with NaN, -0.0 and inf among the values
    and codes spread over all g groups."""
    codes, mask, vals = _tiles(rng, n, "f32", g, nan=True)
    vals[0, :6] = [-0.0, -0.0, np.inf, -np.inf, 1e30, -1e-30]
    codes[0, :2] = 0         # a group whose first rows are -0.0
    return codes, mask, vals


@pytest.mark.parametrize("where", ["scalar", "small", "edge", "edge+1",
                                   "100003", "1000001"])
def test_regimes_hold_the_reference(where):
    """agg_scan_plain then agg_fold_plain (through ops/agg.py) against the
    reference's group_sum_float, group_min_max and group_count_scatter in
    every regime of the split."""
    lim = _small_limit([K.AGG_SUM_F])
    g = {"scalar": 1, "small": 201, "edge": lim, "edge+1": lim + 1,
         "100003": 100_003, "1000001": 1_000_001}[where]
    regime = K.split(_spec(g, [K.AGG_SUM_F]), 9000).regime
    assert regime == (K.REGIME_SCALAR if g == 1 else K.REGIME_SMALL
                      if g <= lim else K.REGIME_SORT)
    rng = np.random.default_rng(g)
    codes, mask, vals = _float_data(rng, 9000, g)
    (rc, rm, rv), (pc, pm, pv) = _both(codes, mask, vals)
    ref = np.asarray(ragg.group_sum_float(rc, rm, rv, g))
    got = agg.group_sum_float(pc, pm, pv, g).numpy()
    np.testing.assert_allclose(got, ref, rtol=FLOAT_RTOL, atol=1e-3,
                               equal_nan=True)
    for op in ("min", "max"):
        np.testing.assert_array_equal(
            agg.group_min_max(pc, pm, pv, g, op).numpy(),
            np.asarray(ragg.group_min_max(rc, rm, rv, g, op)))
    np.testing.assert_array_equal(
        agg.group_count_scatter(pc, pm, g).numpy(),
        np.asarray(ragg.group_count_scatter(rc, rm, g)))
    # two calls agree bit for bit
    again = agg.group_sum_float(pc, pm, pv, g).numpy()
    np.testing.assert_array_equal(got.view(np.int32), again.view(np.int32))


def _scan_sum(codes, mask, vals, g, t0=0, t1=None):
    """The raw (plane, count) of one f32 sum through agg_scan_plain."""
    spec = K.ScanSpec([K.COL_F32], [0], factorized=g > 1, G=g,
                      aggs=[K.ScanAgg(K.AGG_SUM_F, ((K.OP_COL, 0, 0),))])
    t1 = codes.shape[0] if t1 is None else t1
    c = torch.from_numpy(codes.copy())
    m = torch.from_numpy(mask.copy())
    _, outs = K.agg_scan_plain(spec, [(torch.from_numpy(vals.copy()),
                                       torch.ones_like(m))], m,
                               c if g > 1 else None, t0, t1)
    return spec, outs[0]


def _order_sum(codes, mask, vals, g, spec, n):
    """The kernel's add order written out as loops over its blocks,
    steps, warps and lanes, one np.float32 add at a time."""
    sp = K.split(spec, n)
    f32 = np.float32
    c, m, v = codes.reshape(-1), mask.reshape(-1), vals.reshape(-1)
    with np.errstate(invalid="ignore", over="ignore"):
        if sp.regime == K.REGIME_SORT:
            out = np.zeros(g, np.float32)
            for r in range(n):
                if m[r]:
                    out[c[r]] = f32(out[c[r]] + v[r])
            return out
        plane = np.zeros(sp.blocks * g, np.float32)
        for b in range(sp.blocks):
            r0, r1 = b * sp.rows_per_block, min((b + 1) *
                                                sp.rows_per_block, n)
            if sp.regime == K.REGIME_SCALAR:
                acc = [f32(0)] * K.BLOCK_ROWS
                for base in range(r0, r1, K.BLOCK_ROWS):
                    for t in range(K.BLOCK_ROWS):
                        r = base + t
                        if r < r1 and m[r]:
                            acc[t] = f32(acc[t] + v[r])
                sums = []
                for w in range(K.BLOCK_WARPS):
                    x = acc[32 * w:32 * w + 32]
                    for o in (16, 8, 4, 2, 1):
                        x = [f32(x[i] + x[i + o]) for i in range(o)]
                    sums.append(x[0])
                t = sums[0]
                for w in range(1, K.BLOCK_WARPS):
                    t = f32(t + sums[w])
                plane[b] = t
                continue
            rows = np.zeros((K.BLOCK_WARPS, g), np.float32)
            for base in range(r0, r1, K.BLOCK_ROWS):
                for t in range(K.BLOCK_ROWS):
                    r = base + t
                    if r < r1 and m[r]:
                        w = t // 32
                        rows[w, c[r]] = f32(rows[w, c[r]] + v[r])
            out = rows[0].copy()
            for w in range(1, K.BLOCK_WARPS):
                out = (out + rows[w]).astype(np.float32)
            plane[b * g:(b + 1) * g] = out
        return plane


@pytest.mark.parametrize("g", [1, 13, 1200])
def test_f32_sums_follow_the_stated_order(g):
    """The plain version's f32 planes, bit for bit, against the kernel's
    add order written out one add at a time (SCALAR, SMALL, SORT)."""
    rng = np.random.default_rng(g + 1)
    n = 9000
    codes, mask, vals = _float_data(rng, n, g)
    spec, (plane, count) = _scan_sum(codes, mask, vals, g)
    want = _order_sum(codes, mask, vals, g, spec, codes.size)
    np.testing.assert_array_equal(plane.numpy().view(np.int32),
                                  want.view(np.int32))
    assert int(count.sum()) == int(mask.sum())


def test_large_g_f32_sum_is_np_add_at_in_row_order():
    """At large G the sums need no fold: each group's is 0 + its rows in
    row order, np.add.at's f32 order, bit for bit; -0.0 rows give +0.0."""
    g = 100_003
    rng = np.random.default_rng(4)
    codes, mask, vals = _float_data(rng, 50_000, g)
    spec, (plane, _count) = _scan_sum(codes, mask, vals, g, 2, 300)
    assert K.split(spec, 298 * 128).plane_rows == 1
    sl = slice(2 * 128, 300 * 128)
    c, m, v = (a.reshape(-1)[sl] for a in (codes, mask, vals))
    want = np.zeros(g, np.float32)
    with np.errstate(invalid="ignore"):
        np.add.at(want, c[m], v[m])
    np.testing.assert_array_equal(plane.numpy().view(np.int32),
                                  want.view(np.int32))
    folded = K.agg_fold_plain(plane, g)
    np.testing.assert_array_equal(folded.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("p", [1, 2, 15, 17, 300, 4099, 8192])
def test_fold_tree_is_the_stated_loop(p):
    """agg_fold_plain equals a Python loop over the same runs bit for
    bit: runs of L rows added from their first row, then the runs in
    order."""
    rng = np.random.default_rng(p)
    g = 5
    plane = (rng.standard_normal((p, g)) * 1e3).astype(np.float32)
    plane[rng.random((p, g)) < 0.01] = np.nan
    plane[0, 0] = -0.0
    L, R = K.fold_runs(p)
    assert R <= K.FOLD_RUNS and L >= K.FOLD_MIN_RUN and (R - 1) * L < p
    want = np.empty(g, np.float32)
    for j in range(g):
        runs = []
        for r in range(R):
            s = plane[r * L, j]
            for q in range(r * L + 1, min(r * L + L, p)):
                s = np.float32(s + plane[q, j])
            runs.append(s)
        t = runs[0]
        for s in runs[1:]:
            t = np.float32(t + s)
        want[j] = t
    got = K.agg_fold_plain(torch.from_numpy(plane.reshape(-1)), g).numpy()
    assert np.array_equal(got, want, equal_nan=True)
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin].view(np.int32),
                                  want[fin].view(np.int32))


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
    """A program deeper than the kernel's stack no longer declines: it
    lowers whole, to the reference's values, and the statement runs on
    the device tier split across launches (a derived tile by
    `scan_eval`, then `agg_scan`) with the reference's rows."""
    rconn, pconn = planners
    deep = "k + (k + (k + (k + (k + (k + (k + (k + (k + 1)))))))) > 40"
    pscan, (pe,), _ = _exprs(pconn, pparser, _sql_for(deep))
    rscan, (re_,), _ = _exprs(rconn, rparser, _sql_for(deep))
    pv, pok = _port_eval(pscan, pe)
    rv, rok = _ref_eval(rscan, re_)
    np.testing.assert_array_equal(pok, rok)
    np.testing.assert_array_equal(pv, rv)
    pconn.execute("SET serene_device = 'gpu'")
    LAUNCHES.reset()
    got = pconn.execute(_sql_for(deep)).rows()
    assert LAUNCHES.get("scan_eval.plain") == 1
    assert LAUNCHES.get("agg_scan.plain") == 1
    rconn.execute("SET serene_device = 'cpu'")
    assert got == rconn.execute(_sql_for(deep)).rows()
