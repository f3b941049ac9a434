"""The port's vector tier against the JAX package's, on the CPU.

The same numpy-seeded vectors go through both packages: the reference's
IVF and MaxSim indexes cross to the port with `carry` (centroids, segment
arrays, options), so the probes compare over identical layouts, and the
port runs the plain PyTorch versions of its kernels on CPU tensors.

Bit parity: the port's distances never contract a product into an fma, so
they equal `host_dist` (numpy) bit for bit on any data. The reference's
XLA:CPU contracts (serenedb_tpu/ops/vector.py:58-72): on grid-valued data
every chain is exact and the two packages agree bit for bit; on float data
they agree within the chain's rounding-error bound, and rows only differ
where two distances collide within it.
"""

import json

import numpy as np
import pytest
import torch

from serenedb_tpu.columnar.column import Batch as RefBatch
from serenedb_tpu.engine import Database as RefDatabase
from serenedb_tpu.exec.tables import MemTable as RefMemTable
from serenedb_tpu.ops import vector as ref_vops
from serenedb_tpu.search import ivf as ref_ivf
from serenedb_tpu.search.vector_store import VPOOL as REF_VPOOL
from serenedb_tpu.utils.config import REGISTRY as REF_SETTINGS
from serenedb_tpu_torch.carry import (ivf_index_from_reference,
                                      maxsim_index_from_reference)
from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.ops import vector as vops
from serenedb_tpu_torch.ops import select
from serenedb_tpu_torch.ops import vector_kernels as vk
from serenedb_tpu_torch.search.vector_store import VPOOL
from serenedb_tpu_torch.utils.config import REGISTRY as SETTINGS

MAXSIM_RTOL = MAXSIM_ATOL = 1e-5


def _texts(mat):
    return [json.dumps([float(x) for x in row]) for row in mat]


def _ref_provider(texts, name="t"):
    return RefMemTable(name, RefBatch.from_pydict({"v": texts}))


def _ivf_fields(idx):
    return {"column": idx.column, "dim": idx.dim, "lists": idx.lists,
            "metric": idx.metric, "centroids": np.asarray(idx.centroids),
            "segs": [(s.vals, s.rows, s.codes) for s in idx.segs],
            "num_rows": idx.num_rows, "data_version": idx.data_version,
            "mutation_epoch": idx.mutation_epoch, "options": idx.options,
            "quantized": idx.quantized, "host_vectors": idx.host_vectors,
            "sq8_lo": idx.sq8_lo, "sq8_scale": idx.sq8_scale}


def _maxsim_fields(idx):
    return {"column": idx.column, "dim": idx.dim,
            "segs": [(s.vals, s.rows, s.codes) for s in idx.segs],
            "doc_rows": idx.doc_rows, "num_rows": idx.num_rows,
            "data_version": idx.data_version,
            "mutation_epoch": idx.mutation_epoch, "options": idx.options}


def _grid(n, d, seed):
    """Vectors on the 1/4 grid in [-2, 2]: every chain over them is exact."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, size=(n, d)).astype(np.float32) / 4


def _indexes(mat, metric, lists=16):
    ref = ref_ivf.build_ivf_index(_ref_provider(_texts(mat)), "v",
                                  {"lists": lists, "metric": metric})
    return ref, ivf_index_from_reference(_ivf_fields(ref), device="cpu")


def _host_select(mat, q, metric, k):
    """numpy host_dist over every row, then the (dist, row) selection."""
    out_d, out_r = [], []
    for qv in q:
        d = ref_vops.host_dist(mat, qv[None, :], metric)
        order = np.lexsort((np.arange(len(d)), d))[:k]
        out_d.append(d[order])
        out_r.append(order)
    return np.stack(out_d), np.stack(out_r)


def _bits(a):
    """The f32 bits, -0.0 read as +0.0: XLA:CPU folds the reference's
    `+ 0.0`, so its exact-zero ip distances come out -0.0 where its own
    host_dist (and the port) give +0.0 (ROADMAP Queue 3); both sort the
    two zeros together."""
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.int32)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_probe_bits_equal_reference_on_grid_data(metric):
    mat = _grid(600, 12, seed=1)
    ref, port = _indexes(mat, metric)
    q = _grid(9, 12, seed=2)
    for nprobe in (1, 8, ref.lists):
        rd, rr = ref.search(q, 10, nprobe)
        pd, pr = port.search(q, 10, nprobe)
        np.testing.assert_array_equal(_bits(pd), _bits(rd), err_msg=nprobe)
        np.testing.assert_array_equal(pr, rr, err_msg=nprobe)
    # full probe = the brute oracle = numpy host_dist + (dist, row) order
    bd, br = port.brute_search(q, 10)
    rbd, rbr = ref.brute_search(q, 10)
    hd, hr = _host_select(mat, q, metric, 10)
    pd, pr = port.search(q, 10, ref.lists)
    for d, r in ((bd, br), (rbd, rbr), (hd, hr)):
        np.testing.assert_array_equal(_bits(pd), _bits(d))
        np.testing.assert_array_equal(pr, r)


def _chain_tol(x, q, metric):
    """The rounding-error bound of two evaluations of one f32 chain that
    differ in contraction: 2 * d * eps * (sum of |terms|)."""
    x = x.astype(np.float64)
    q = q.astype(np.float64)
    d = x.shape[-1]
    eps = np.finfo(np.float32).eps
    if metric == "l2":
        s = ((x - q) ** 2).sum(-1)
    elif metric == "ip":
        s = np.abs(x * q).sum(-1)
    else:
        den = np.maximum(np.linalg.norm(x, axis=-1) *
                         np.linalg.norm(q, axis=-1), 1e-9)
        s = np.abs(x * q).sum(-1) / den + 1.0
    return 2 * d * eps * s


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_probe_on_float_data_is_host_dist_exact(metric):
    rng = np.random.default_rng(7)
    mat = rng.standard_normal((500, 24)).astype(np.float32)
    ref, port = _indexes(mat, metric, lists=8)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    pd, pr = port.search(q, 12, port.lists)
    hd, hr = _host_select(mat, q, metric, 12)
    np.testing.assert_array_equal(_bits(pd), _bits(hd))
    np.testing.assert_array_equal(pr, hr)
    for nprobe in (1, 3, port.lists):
        rd, rr = ref.search(q, 12, nprobe)
        pd, pr = port.search(q, 12, nprobe)
        for i in range(len(q)):
            # XLA:CPU contracts products into fmas (ROADMAP Queue 3: more
            # than the 1 ulp the reference's docstring states), so the
            # distances agree within the chain's rounding-error bound
            tol = _chain_tol(mat[pr[i]], q[i], metric)
            np.testing.assert_array_less(np.abs(pd[i] - rd[i]), tol + 1e-30)
            for j in np.flatnonzero(pr[i] != rr[i]):
                # rows differ only where two distances collide within it
                assert np.sum(np.abs(rd[i] - rd[i, j]) <= 2 * tol[j]) > 1


def test_probe_nan_inf_and_dead_lanes_order_as_the_reference():
    """Rows whose distance is NaN never reach the output (the reference's
    carry starts with dead entries that sort before NaN); +inf rows sort
    before the dead lanes; a k past the live rows reads (+inf, 2^31-1)."""
    mat = _grid(40, 4, seed=3)
    mat[3] = np.nan
    mat[7, 1] = np.inf
    mat[11, 0] = -np.inf
    ref, port = _indexes(mat, "l2", lists=4)
    q = _grid(3, 4, seed=4)
    for k, nprobe in ((10, 1), (40, 4), (39, 2)):
        rd, rr = ref.search(q, k, nprobe)
        pd, pr = port.search(q, k, nprobe)
        np.testing.assert_array_equal(_bits(pd), _bits(rd))
        np.testing.assert_array_equal(pr, rr)
    assert not np.isin(3, pr[np.isfinite(pd)])
    assert (pr[~np.isfinite(pd)] >= 0).all()


def test_nprobe_ties_take_the_lower_list():
    """Every centroid at the same distance: both packages probe the lowest
    list ids first."""
    mat = np.zeros((64, 4), np.float32)
    mat[:, 0] = np.repeat(np.arange(8), 8)
    ref, port = _indexes(mat, "ip", lists=8)
    q = np.zeros((2, 4), np.float32)            # ip distance 0 to all
    for nprobe in (1, 3, 8):
        rd, rr = ref.search(q, 20, nprobe)
        pd, pr = port.search(q, 20, nprobe)
        np.testing.assert_array_equal(pr, rr)
        np.testing.assert_array_equal(_bits(pd), _bits(rd))


def test_kmeans_on_separated_integer_data_equals_reference_bits():
    rng = np.random.default_rng(5)
    centers = rng.integers(-60, 60, size=(6, 8)) * 8
    x = (centers[rng.integers(0, 6, 400)] +
         rng.integers(-3, 4, size=(400, 8))).astype(np.float32)
    init = ref_vops.init_centroids(x, 6)
    xp = ref_vops.pad_rows(x)
    rc = np.asarray(ref_vops.kmeans_fit(xp, init, 6, 8))
    pc = vops.kmeans_fit(torch.from_numpy(xp), torch.from_numpy(init), 6,
                         8).numpy()
    np.testing.assert_array_equal(_bits(pc), _bits(rc))
    rcodes = np.asarray(ref_vops.assign_clusters(xp, rc))
    pcodes = vops.assign_clusters(torch.from_numpy(xp),
                                  torch.from_numpy(pc)).numpy()
    np.testing.assert_array_equal(pcodes, rcodes)


def test_kmeans_on_float_data_within_tolerance():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((700, 16)).astype(np.float32)
    init = ref_vops.init_centroids(x, 12)
    xp = ref_vops.pad_rows(x)
    rc = np.asarray(ref_vops.kmeans_fit(xp, init, 12, 4))
    pc = vops.kmeans_fit(torch.from_numpy(xp), torch.from_numpy(init), 12,
                         4).numpy()
    np.testing.assert_allclose(pc, rc, rtol=1e-5, atol=1e-6)
    pcodes = vops.assign_clusters(torch.from_numpy(xp),
                                  torch.from_numpy(pc)).numpy()
    rcodes = np.asarray(ref_vops.assign_clusters(xp, rc))
    d = ((xp[:, None, :].astype(np.float64) - rc[None].astype(np.float64))
         ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    near_tie = (two[:, 1] - two[:, 0]) <= 1e-5 * np.abs(two[:, 1])
    assert ((pcodes == rcodes) | near_tie).all()


def test_kmeans_kernels_plain_semantics():
    """kmeans_assign: lowest index on ties, the first NaN wins;
    kmeans_update: an empty cluster keeps its centroid."""
    x = torch.tensor([[0., 0.], [2., 0.], [1., 0.], [np.nan, 0.]])
    c = torch.tensor([[1., 1.], [1., -1.], [0., 0.], [5., 5.]])
    a = vk.kmeans_assign(x, c, x @ c.t())
    assert a.tolist() == [2, 0, 0, 0]
    new = vk.kmeans_update(x[:3].contiguous(),
                           torch.tensor([2, 2, 0], dtype=torch.int32), c)
    assert new[3].tolist() == [5., 5.] and new[1].tolist() == [1., -1.]
    assert new[2].tolist() == [1., 0.] and new[0].tolist() == [1., 0.]


def _chunk_order_update(x, assign, c, chunk):
    """kmeans_update's documented order as numpy loops: each cluster's
    rows in row order, in chunks of `chunk` rows; a chunk sums its rows
    in order from +0.0 in f32, the cluster its chunk sums in order; then
    the IEEE-rounded quotient, or the old centroid where the cluster is
    empty."""
    out = c.copy()
    for cl in range(c.shape[0]):
        rows = np.nonzero(assign == cl)[0]
        if len(rows) == 0:
            continue
        total = np.zeros(x.shape[1], np.float32)
        for j0 in range(0, len(rows), chunk):
            acc = np.zeros(x.shape[1], np.float32)
            for r in rows[j0:j0 + chunk]:
                acc = (acc + x[r]).astype(np.float32)
            total = (total + acc).astype(np.float32)
        out[cl] = (total.astype(np.float64) / len(rows)).astype(np.float32)
    return out


@pytest.mark.parametrize("d", [3, 130])
def test_kmeans_update_plain_follows_the_chunk_order(d):
    """A skewed assignment (one cluster holds ~90 % of the rows: 7 full
    chunks and a partial one), an empty cluster, n not a multiple of the
    chunk, float data: bit for bit against the loops."""
    rng = np.random.default_rng(d)
    n, k = 1001, 6
    x = (rng.standard_normal((n, d)) * 3.0).astype(np.float32)
    a = np.where(rng.random(n) < 0.9, 2, rng.integers(0, k, n))
    a[a == 4] = 0                                    # cluster 4 empty
    c = rng.standard_normal((k, d)).astype(np.float32)
    assert np.bincount(a, minlength=k)[2] > 7 * vk.KMEANS_CHUNK
    want = _chunk_order_update(x, a, c, vk.KMEANS_CHUNK)
    got = vk.kmeans_update(torch.from_numpy(x),
                           torch.from_numpy(a.astype(np.int32)),
                           torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_kmeans_on_skewed_128_dim_data_within_tolerance():
    """JAX parity at D = 128 with one cluster holding ~90 % of the rows."""
    rng = np.random.default_rng(17)
    n, d, k = 900, 128, 8
    centers = rng.standard_normal((k, d)) * 10.0
    which = np.where(rng.random(n) < 0.9, 0, rng.integers(1, k, n))
    which[:k] = np.arange(k)
    x = (centers[which] + rng.standard_normal((n, d))).astype(np.float32)
    init = x[:k].copy()                  # one seed row a cluster
    xp = ref_vops.pad_rows(x)
    rc = np.asarray(ref_vops.kmeans_fit(xp, init, k, 4))
    pc = vops.kmeans_fit(torch.from_numpy(xp), torch.from_numpy(init), k,
                         4).numpy()
    np.testing.assert_allclose(pc, rc, rtol=1e-5, atol=1e-6)


def _maxsim_corpus(n_docs, dim, seed):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        t = rng.standard_normal((rng.integers(1, 7), dim))
        docs.append((t / np.linalg.norm(t, axis=1, keepdims=True))
                    .astype(np.float32))
    return docs


def test_maxsim_matches_reference_and_host_scores():
    docs = _maxsim_corpus(70, 16, seed=8)
    texts = [json.dumps(d.tolist()) for d in docs]
    texts[5] = None                                # a doc without tokens
    ref = ref_ivf.build_maxsim_index(_ref_provider(texts), "v", {})
    port = maxsim_index_from_reference(_maxsim_fields(ref), device="cpu")
    rng = np.random.default_rng(9)
    q = rng.standard_normal((4, 5, 16)).astype(np.float32)
    q[2, 3:] = 0.0                                 # zero query tokens
    rk, rr = ref.search_batch(q, 10)
    pk, pr = port.search_batch(q, 10)
    np.testing.assert_allclose(pk, rk, rtol=MAXSIM_RTOL, atol=MAXSIM_ATOL)
    for b in range(4):
        hs = port.host_scores(q[b])
        order = np.lexsort((port.doc_rows, -hs))[:10]
        np.testing.assert_allclose(-pk[b], hs[order], rtol=MAXSIM_RTOL,
                                   atol=MAXSIM_ATOL)
        for j in np.flatnonzero(pr[b] != port.doc_rows[order]):
            assert np.sum(np.isclose(hs, hs[order[j]], rtol=MAXSIM_RTOL,
                                     atol=MAXSIM_ATOL)) > 1
        for j in np.flatnonzero(pr[b] != rr[b]):
            assert np.sum(np.isclose(-rk[b], -rk[b, j], rtol=MAXSIM_RTOL,
                                     atol=MAXSIM_ATOL)) > 1
    # k past the docs: dead lanes read +inf, as the reference's
    rk, rr = ref.search_batch(q[:1], 80)
    pk, pr = port.search_batch(q[:1], 80)
    np.testing.assert_array_equal(np.isfinite(pk), np.isfinite(rk))
    np.testing.assert_array_equal(pr[~np.isfinite(pk)],
                                  rr[~np.isfinite(rk)])


def _sql_pair(setup):
    out = []
    for db in (RefDatabase(), Database(device="cpu")):
        c = db.connect()
        for st in setup:
            c.execute(st)
        out.append((db, c))
    return out


def _rows_equal(q, pairs):
    (_, rc), (_, pc) = pairs
    assert pc.execute(q).rows() == rc.execute(q).rows(), q
    assert pc.execute("EXPLAIN " + q).rows() == \
        rc.execute("EXPLAIN " + q).rows(), q


def _vec(v):
    return json.dumps([float(x) for x in v])


def test_vector_sql_equals_reference():
    mat = _grid(400, 8, seed=11)
    setup = ["CREATE TABLE t (id INT, v VARCHAR)",
             "INSERT INTO t VALUES " + ", ".join(
                 f"({i}, '{_vec(r)}')" for i, r in enumerate(mat)),
             "CREATE INDEX tv ON t USING ivf (v) WITH (lists = 16)"]
    pairs = _sql_pair(setup)
    q = _vec(_grid(1, 8, seed=12)[0])
    for op in ("<->", "<#>", "<=>"):
        _rows_equal(f"SELECT id, v {op} '{q}' AS d FROM t ORDER BY "
                    f"v {op} '{q}' LIMIT 7", pairs)
    for _, c in pairs:
        c.execute("SET serene_nprobe = 16")
    _rows_equal(f"SELECT id FROM t ORDER BY v <-> '{q}' LIMIT 12", pairs)
    # an append: the index gains a tail segment in both packages
    for _, c in pairs:
        c.execute("INSERT INTO t VALUES " + ", ".join(
            f"({400 + i}, '{_vec(r)}')"
            for i, r in enumerate(_grid(30, 8, seed=13))))
    _rows_equal(f"SELECT id, v <-> '{q}' AS d FROM t ORDER BY v <-> '{q}' "
                f"LIMIT 9", pairs)
    segs = [len(db.resolve_table(["t"]).indexes["tv"].segs)
            for db, _ in pairs]
    assert segs == [2, 2]


def test_sq8_and_pool_off_equal_reference():
    mat = _grid(300, 8, seed=14)
    setup = ["CREATE TABLE t (id INT, v VARCHAR)",
             "INSERT INTO t VALUES " + ", ".join(
                 f"({i}, '{_vec(r)}')" for i, r in enumerate(mat)),
             "CREATE INDEX tq ON t USING ivf (v) WITH (lists = 8, "
             "quantization = 'sq8')"]
    pairs = _sql_pair(setup)
    q = _vec(_grid(1, 8, seed=15)[0])
    stmt = f"SELECT id, v <-> '{q}' AS d FROM t ORDER BY v <-> '{q}' LIMIT 8"
    _rows_equal(stmt, pairs)
    on = pairs[1][1].execute(stmt).rows()
    for reg in (REF_SETTINGS, SETTINGS):
        reg.set_global("serene_vector_pool", False)
    try:
        _rows_equal(stmt, pairs)
        assert pairs[1][1].execute(stmt).rows() == on
    finally:
        for reg in (REF_SETTINGS, SETTINGS):
            reg.set_global("serene_vector_pool", True)


def test_maxsim_sql_equals_reference():
    docs = _maxsim_corpus(50, 8, seed=16)
    setup = ["CREATE TABLE m (id INT, c VARCHAR)",
             "INSERT INTO m VALUES " + ", ".join(
                 f"({i}, '{json.dumps(d.tolist())}')"
                 for i, d in enumerate(docs)),
             "CREATE INDEX mc ON m USING maxsim (c)"]
    pairs = _sql_pair(setup)
    q = json.dumps(_maxsim_corpus(1, 8, seed=17)[0].tolist())
    stmt = (f"SELECT id, vec_maxsim(c, '{q}') AS s FROM m ORDER BY "
            f"vec_maxsim(c, '{q}') DESC LIMIT 6")
    (_, rc), (_, pc) = pairs
    assert pc.execute("EXPLAIN " + stmt).rows() == \
        rc.execute("EXPLAIN " + stmt).rows()
    assert "MaxSimScan" in str(pc.execute("EXPLAIN " + stmt).rows())
    for want, got in ((rc.execute(stmt).rows(), pc.execute(stmt).rows()),):
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                                   rtol=MAXSIM_RTOL, atol=MAXSIM_ATOL)


def test_vector_pool_rows_and_warm_repeat_uploads_only_the_queries():
    """The pool's rows (the sdb_vector_pool view; the reference serves them
    through VectorPool.snapshot) hold the same vectors, pages, bytes and
    hits; a warm repeat uploads nothing but its (qp, dp) query block."""
    mat = _grid(500, 16, seed=18)
    rows = []
    for pool, db in ((REF_VPOOL, RefDatabase()),
                     (VPOOL, Database(device="cpu"))):
        pool.clear()
        c = db.connect()
        c.execute("CREATE TABLE t (id INT, v VARCHAR)")
        c.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i}, '{_vec(r)}')" for i, r in enumerate(mat)))
        c.execute("CREATE INDEX tv ON t USING ivf (v) WITH (lists = 8)")
        stmts = [f"SELECT id FROM t ORDER BY v <-> '{_vec(mat[i])}' LIMIT 5"
                 for i in (3, 4)]
        c.execute(stmts[0])
        if pool is VPOOL:
            # warm: the pages are resident, a new query (a repeat would be
            # served by the index's fragment memo without a launch)
            before, launches = UPLOADS.get("bytes"), LAUNCHES.snapshot()
            c.execute(stmts[1])
            assert UPLOADS.get("bytes") - before == 1 * 16 * 4
            assert LAUNCHES.get("ivf_probe.plain") == \
                launches.get("ivf_probe.plain", 0) + 1
        else:
            c.execute(stmts[1])
        rows.append([{k: r[k] for k in ("vectors", "pages", "bytes", "hits",
                                        "data_version", "mutation_epoch")}
                     for r in pool.snapshot()])
        pool.clear()
    assert rows[0] == rows[1] and rows[1] and rows[1][0]["hits"] == 1


def _levels_model(keys, run, keep, floor):
    """numpy model of csrc/select.cuh `sel::levels` (flat tile levels, then
    merge-path pair merges), checking every level against the buffers
    `select.scratch` sizes."""
    rows, n = keys.shape
    no = np.uint64(2**64 - 1)
    cap = select.scratch(rows, n, run, keep, floor)
    tile = select.tile_for(keep, floor)
    kt = min(keep, tile)
    cur, level = keys, 0
    assert rows * n <= cap[0]
    while n != keep or run < keep:
        level += 1
        if 2 * keep <= tile or run < kt:
            nt = -(-n // tile)
            pad = np.full((rows, nt * tile - n), no)
            t = np.sort(np.concatenate([cur, pad], 1).reshape(rows, nt, tile),
                        axis=2)[:, :, :kt]
            n, run, cur = nt * kt, kt, t.reshape(rows, -1)
        else:
            nr, r2 = n // run, min(2 * run, keep)
            runs = cur.reshape(rows, nr, run)
            out = np.empty((rows, -(-nr // 2), r2), np.uint64)
            for p in range(-(-nr // 2)):
                a = runs[:, 2 * p]
                b = runs[:, 2 * p + 1] if 2 * p + 1 < nr else \
                    np.full_like(a, no)
                for row in range(rows):
                    pa = np.arange(run) + np.searchsorted(b[row], a[row],
                                                          "left")
                    pb = np.arange(run) + np.searchsorted(a[row], b[row],
                                                          "right")
                    m = np.empty(2 * run, np.uint64)
                    m[pa], m[pb] = a[row], b[row]
                    out[row, p] = m[:r2]
            n, run, cur = out.shape[1] * r2, r2, out.reshape(rows, -1)
        assert rows * n <= cap[level % 2]
    return cur


@pytest.mark.parametrize("n,keep,floor", [
    (5, 8, 2048), (100, 8, 32), (50_000, 3, 2048), (20_000, 5000, 32),
    (20_000, 20_000, 32), (3 * 8192, 9000, 2048), (100, 10_000, 2048),
    (7, 7, 32), (9, 1, 2)])
def test_select_levels_keep_the_smallest_keys_within_their_buffers(
        n, keep, floor):
    """The selection that ivf_probe, maxsim and topk_rows share, at every
    keep (past one tile's 4,096 too), with repeated keys (dead lanes)."""
    rng = np.random.default_rng(n + keep)
    keys = rng.integers(0, 1000, size=(2, n)).astype(np.uint64)
    keys[:, ::7] = np.uint64(2**63 + 5)
    got = _levels_model(keys, 1, keep, floor)
    pad = np.full((2, max(keep - n, 0)), np.uint64(2**64 - 1))
    want = np.sort(np.concatenate([keys, pad], 1), 1)[:, :keep]
    np.testing.assert_array_equal(got, want)


def _merge_runs_model(buf, nruns, run, k, span):
    """numpy model of csrc/vector.cu `merge_runs`: pairwise merge-path
    merges of nruns sorted runs of `run` keys, each cut to k, every round
    within the `span` keys `merge_span` gives a buffer."""
    no = np.uint64(2**64 - 1)
    cur = buf[:nruns * run]
    while nruns > 1:
        np_, run2 = (nruns + 1) // 2, min(2 * run, k)
        out = np.empty(np_ * run2, np.uint64)
        for p in range(np_):
            a = cur[2 * p * run:(2 * p + 1) * run]
            b = cur[(2 * p + 1) * run:(2 * p + 2) * run] \
                if 2 * p + 1 < nruns else np.full(run, no)
            out[p * run2:(p + 1) * run2] = np.sort(
                np.concatenate([a, b]), kind="stable")[:run2]
        assert out.size <= span
        cur, nruns, run = out, np_, run2
    return cur[:run]


@pytest.mark.parametrize("nruns,run,k", [(1, 16, 16), (5, 32, 16),
                                         (12, 32, 256), (3, 16, 64),
                                         (256, 16, 16), (8, 128, 1024),
                                         (17, 7, 40)])
def test_probe_merge_span_bounds_the_block_merge(nruns, run, k):
    """`merge_span` bounds every round of a block's merge of sorted runs
    (the buffers the kernel carves from shared memory), and the merge
    keeps the k smallest keys."""
    rng = np.random.default_rng(nruns * run + k)
    keys = np.sort(rng.integers(0, 500, (nruns, run)).astype(np.uint64), 1)
    span = vk.merge_span(nruns, run, k)
    assert span >= nruns * run
    got = _merge_runs_model(keys.reshape(-1), nruns, run, k, span)
    want = np.sort(keys.reshape(-1))[:min(k, nruns * run)]
    np.testing.assert_array_equal(got[:want.size], want)


def _probe_select_model(keys, plan, k):
    """numpy model of a fused probe stage 2's selection (csrc/vector.cu):
    block j of plan.blocks takes tiles j, j + blocks, ... of 128 keys;
    each tile is sorted by 32-key warps and merged into the block's
    running best (kept to plan.keep, padded to a multiple of 32); the last
    block of each group of plan.group merges the group's keys to k, and
    the groups' runs (padded to k) are merged to k where more than one
    group has work."""
    no = np.uint64(2**64 - 1)
    T = vk.PROBE_TILE
    kpad = -(-plan.keep // 32) * 32
    ntiles = -(-keys.size // T)
    nwork = max(1, min(ntiles, plan.blocks))
    cand = []
    for c in range(nwork):
        best = np.full(kpad, no)
        for t in range(c, ntiles, plan.blocks):
            tile = np.full(T, no)
            part = keys[t * T:(t + 1) * T]
            tile[:part.size] = part
            tile = np.sort(tile.reshape(-1, 32), 1).reshape(-1)
            runs = np.concatenate([best, tile])
            merged = _merge_runs_model(runs, runs.size // 32, 32, plan.keep,
                                       vk.merge_span(runs.size // 32, 32,
                                                     plan.keep))
            best = np.full(kpad, no)
            best[:plan.keep] = merged[:plan.keep]
        cand.append(best[:plan.keep])
    span_g = vk.merge_span(plan.group, plan.keep, k)
    groups = []
    for g0 in range(0, nwork, plan.group):
        part = cand[g0:g0 + plan.group]
        run = _merge_runs_model(np.concatenate(part), len(part), plan.keep,
                                k, span_g)
        if nwork <= plan.group:
            return run
        pad = np.full(k, no)
        pad[:run.size] = run
        groups.append(pad)
    return _merge_runs_model(np.concatenate(groups), len(groups), k, k,
                             vk.merge_span(plan.groups, k, k))


@pytest.mark.parametrize("n,k,qp", [(20_480, 16, 1), (20_480, 16, 64),
                                    (0, 16, 1), (1, 16, 1), (127, 16, 3),
                                    (129, 200, 1), (40_000, 64, 7),
                                    (5000, 256, 1), (300, 300, 2),
                                    (114_688, 16, 1), (114_688, 16, 64),
                                    (100_000, 256, 1), (300_032, 256, 16)])
def test_probe_stage_selection_model_keeps_the_smallest(n, k, qp):
    """The fused stage's selection (per-warp sorts, running merges over a
    block's tiles, the groups' and the last group's merges) keeps each
    query's k smallest keys, the live rows at any count (none, part of a
    tile, many tiles a block, many groups)."""
    plan = vk.stage_plan(max(n, 1), k, qp)
    assert plan.fused
    rng = np.random.default_rng(n + k + qp)
    keys = rng.permutation(10 * n + 5)[:n].astype(np.uint64)
    got = _probe_select_model(keys, plan, k)
    want = np.sort(keys)[:k]
    np.testing.assert_array_equal(got[:want.size], want)
    assert (got[want.size:] == np.uint64(2**64 - 1)).all()


def test_probe_stage_plan_regimes():
    """The stage plans of the main path's calls and of the levels."""
    P = vk.StagePlan
    # sift: 1,024 lists keeping 16, one merge by each stage 2 block
    assert vk.stage_plan(1024, 16, 0) == P(True, 1, 16, 8, 8, 1)
    # its 20,480 lanes (16 x its 1,250-row list): at batch 1 a block a
    # tile in 5 groups; at batch 64 32 blocks a query, 5 tiles each
    assert vk.stage_plan(20_480, 16, 1) == P(True, 1, 16, 32, 160, 5)
    assert vk.stage_plan(20_480, 16, 64) == P(True, 5, 16, 32, 32, 1)
    # the synthetic skew (114,688 lanes) at batch 1, the brute layout at 16
    # queries
    assert vk.stage_plan(114_688, 16, 1) == P(True, 1, 16, 32, 896, 28)
    assert vk.stage_plan(1_000_448, 16, 16) == P(True, 62, 16, 32, 128, 4)
    # LIMIT 256 over 100,000 rows: blocks of 4 tiles, groups of 16
    assert vk.stage_plan(100_000, 256, 1) == P(True, 4, 256, 16, 196, 13)
    # nprobe = lists = 1,024: 8 blocks of all their 128 lists; 16,384
    # lists keeping 64: 2 tiles a block
    assert vk.stage_plan(1024, 1024, 0) == P(True, 1, 128, 8, 8, 1)
    assert vk.stage_plan(16_384, 64, 0) == P(True, 2, 64, 64, 64, 1)
    # past one block's merges: one tile a block, the levels
    assert vk.stage_plan(40_960, 8192, 3) == P(False, 1, 128, 1, 320, 1)
    assert vk.stage_plan(8192, 5000, 0) == P(False, 1, 128, 1, 64, 1)
    for n, k, qp in ((1, 1, 1), (20_480, 16, 1), (1_000_448, 16, 64),
                     (5000, 256, 3)):
        p = vk.stage_plan(n, k, qp)
        assert p.blocks * p.tpb * vk.PROBE_TILE >= n
        assert p.groups * p.group >= p.blocks
        assert vk.merge_span(p.group, p.keep, k) <= vk.PROBE_MERGE_CAP
        assert vk.merge_span(p.groups, k, k) <= vk.PROBE_MERGE_CAP


def test_probe_plan_carves_one_scratch_and_counts_kernels():
    """Both stages fused: two kernels; the scratch holds each stage's
    candidates and the tickets. A stage past one block's merge adds its
    levels and a finishing kernel, and its buffers."""
    p = vk.probe_plan(1, 1024, 16, 20_480, 16)
    assert p.kernels == vk.PROBE_CALL_KERNELS == 2
    c1, c2, grp = 8 * 16 * 8, 160 * 16 * 8, 5 * 16 * 8
    assert p.bytes == c1 + c2 + grp + 6 * 4 + 8      # 16-byte aligned
    p = vk.probe_plan(64, 1024, 16, 20_480, 16)      # one group a query
    assert p.kernels == 2
    assert p.bytes == 64 * 8 * 16 * 8 + 64 * 32 * 16 * 8 + 64 * 2 * 4
    q = vk.probe_plan(3, 64, 8, 40_960, 8192)
    assert q.lists.fused and not q.rows.fused
    n2 = q.rows.blocks * q.rows.keep
    a2, b2 = select.scratch(3, n2, q.rows.keep, 8192, vk.STAGE_FLOOR)
    levels = len(select.level_sizes(n2, q.rows.keep, 8192,
                                    vk.STAGE_FLOOR)) - 1
    assert q.kernels == 2 + levels + 1
    c1 = 3 * q.lists.blocks * q.lists.keep * 8
    assert q.bytes >= c1 + a2 * 8 + b2 * 8 + 3 * 4
    r = vk.probe_plan(3, 8192, 5000, 81_920, 16)
    assert not r.lists.fused and r.rows.fused
    # the probe table: list ids and the (nprobe + 1) prefix a query
    assert r.bytes >= 3 * 5000 * 4 + 3 * 5001 * 8


def _limit_pairs(quant):
    rng = np.random.default_rng(31)
    mat = rng.integers(-8, 9, size=(10_400, 4)).astype(np.float32) / 4
    return _sql_pair(["CREATE TABLE t (id INT, v VARCHAR)",
                      "INSERT INTO t VALUES " + ", ".join(
                          f"({i}, '{_vec(r)}')" for i, r in enumerate(mat)),
                      "CREATE INDEX tv ON t USING ivf (v) WITH (lists = 16"
                      + quant + ")"])


@pytest.mark.parametrize("quant", ["", ", quantization = 'sq8'"])
def test_limit_past_one_selection_tile_equals_reference(quant):
    """LIMIT 10000 keeps 16,384 keys a query (and sq8 fetches 4x): the
    selection runs past one tile. Without sq8 the rows equal the
    reference's; with it the exact rerank keeps equal distances in the
    order of the dequantized candidates, whose bits the reference's
    XLA:CPU may round 1 ulp apart, so rows are compared in (d, id) order
    and the distances in the statement's own order."""
    pairs = _limit_pairs(quant)
    q = _vec([0.25, -0.5, 1.0, 0.0])
    stmt = (f"SELECT id, v <-> '{q}' AS d FROM t ORDER BY v <-> '{q}' "
            "LIMIT 10000")
    (_, rc), (_, pc) = pairs
    want, got = rc.execute(stmt).rows(), pc.execute(stmt).rows()
    assert len(got) == len(want) > 4096
    assert [r[1] for r in got] == [r[1] for r in want]
    if quant:
        assert sorted(got, key=lambda r: (r[1], r[0])) == \
            sorted(want, key=lambda r: (r[1], r[0]))
    else:
        assert got == want
    assert pc.execute("EXPLAIN " + stmt).rows() == \
        rc.execute("EXPLAIN " + stmt).rows()


def test_maxsim_long_docs_match_reference_and_host_scores():
    """Docs of 300 tokens (ColBERTv2's doc_maxlen) and 1,030 (a ColPali
    page) at 128 dims: the kernel streams tokens, so no length is refused."""
    rng = np.random.default_rng(41)
    docs = []
    for n_tok in (300, 1030, 300, 17, 299, 300, 64, 1):
        t = rng.standard_normal((n_tok, 128))
        docs.append((t / np.linalg.norm(t, axis=1, keepdims=True))
                    .astype(np.float32))
    ref = ref_ivf.build_maxsim_index(
        _ref_provider([json.dumps(d.tolist()) for d in docs]), "v", {})
    port = maxsim_index_from_reference(_maxsim_fields(ref), device="cpu")
    q = rng.standard_normal((2, 32, 128)).astype(np.float32)
    rk, rr = ref.search_batch(q, 5)
    pk, pr = port.search_batch(q, 5)
    np.testing.assert_allclose(pk, rk, rtol=MAXSIM_RTOL, atol=MAXSIM_ATOL)
    for b in range(2):
        hs = port.host_scores(q[b])
        order = np.lexsort((port.doc_rows, -hs))[:5]
        np.testing.assert_allclose(-pk[b], hs[order], rtol=MAXSIM_RTOL,
                                   atol=MAXSIM_ATOL)
        np.testing.assert_array_equal(pr[b], port.doc_rows[order])
        np.testing.assert_array_equal(pr[b], rr[b])


def test_maxsim_sql_with_300_token_docs_equals_reference():
    rng = np.random.default_rng(42)
    docs = []
    for n_tok in (300, 120, 300, 5, 280, 300):
        t = rng.standard_normal((n_tok, 16))
        docs.append(np.round(t / np.linalg.norm(t, axis=1, keepdims=True),
                             4).astype(np.float32))
    pairs = _sql_pair(["CREATE TABLE m (id INT, c VARCHAR)",
                       "INSERT INTO m VALUES " + ", ".join(
                           f"({i}, '{json.dumps(d.tolist())}')"
                           for i, d in enumerate(docs)),
                       "CREATE INDEX mc ON m USING maxsim (c)"])
    q = json.dumps(np.round(rng.standard_normal((32, 16)), 4).tolist())
    stmt = (f"SELECT id, vec_maxsim(c, '{q}') AS s FROM m ORDER BY "
            f"vec_maxsim(c, '{q}') DESC LIMIT 4")
    (_, rc), (_, pc) = pairs
    want, got = rc.execute(stmt).rows(), pc.execute(stmt).rows()
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=MAXSIM_RTOL, atol=MAXSIM_ATOL)


def test_maxsim_width_past_the_kernels_shared_memory_is_unsupported(
        monkeypatch):
    """The one width limit left (ROADMAP's standing ruling): the card
    takes token rows up to MAXSIM_MAX_WIDTH floats, the widths that the
    kernel's shared memory held one token of before it streamed dim slabs
    (50,687); past it the card's wrapper raises FEATURE_NOT_SUPPORTED
    before any launch."""
    assert vk.MAXSIM_MAX_WIDTH == 50_687
    monkeypatch.setattr(vk, "_is_cuda", lambda *t: True)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    for dp in (vk.MAXSIM_MAX_WIDTH + 1, 65536):
        with pytest.raises(Exception) as e:
            vk.maxsim(torch.zeros(dp), i32(0), i32(0, 0), i32(1, 0),
                      i32(0, 1), torch.zeros((1, 1, dp)), i32(0, 1),
                      tile=1, tcap=1, kkp=8)
        assert getattr(e.value, "sqlstate", None) == "0A000"


@pytest.mark.parametrize("nlanes,npairs,want", [
    (50_048, 512, 50_048),        # the colbert batch: one range
    (1_000_064, 2_048, 32_768),   # 64 x 32 pairs over 1M docs: 256 MiB
    (100, 3, 100),                # never more than the call's lanes
    (0, 8, 1),
    (10_000, 1 << 22, 32),        # one group of lanes at the least
    (10_000, 100_000, 640),       # whole groups of 32
])
def test_maxsim_scratch_lanes_keep_the_byte_budget(nlanes, npairs, want):
    lanes = vk.maxsim_scratch_lanes(nlanes, npairs)
    assert lanes == want
    assert lanes * npairs * 4 <= vk.MAXSIM_SCRATCH_BYTES or \
        lanes == vk.MAXSIM_LANES


@pytest.mark.parametrize("b,s", [(1, 1), (3, 5)])
def test_maxsim_pair_counts_and_doc_lengths_match_reference(b, s):
    """Pair counts that do not fill the kernel's register micro-tile (1 x
    1; 3 x 5 tokens, padded to 4 x 8) over docs of 0, 1, 33 and 257
    tokens: the plain version the kernel is held to on the card, against
    the reference and host_scores."""
    rng = np.random.default_rng(48 + b)
    texts = []
    for n_tok in (1, 33, 0, 257, 5, 1, 33, 2, 257, 9):
        t = rng.standard_normal((max(n_tok, 1), 24))
        t = (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32)
        texts.append(json.dumps(t[:n_tok].tolist()) if n_tok else None)
    ref = ref_ivf.build_maxsim_index(_ref_provider(texts), "v", {})
    port = maxsim_index_from_reference(_maxsim_fields(ref), device="cpu")
    q = rng.standard_normal((b, s, 24)).astype(np.float32)
    rk, rr = ref.search_batch(q, 6)
    LAUNCHES.reset()
    pk, pr = port.search_batch(q, 6)
    assert LAUNCHES.get("maxsim.plain") == 1
    np.testing.assert_allclose(pk, rk, rtol=MAXSIM_RTOL, atol=MAXSIM_ATOL)
    for i in range(b):
        hs = port.host_scores(q[i])
        order = np.lexsort((port.doc_rows, -hs))[:6]
        np.testing.assert_allclose(-pk[i], hs[order], rtol=MAXSIM_RTOL,
                                   atol=MAXSIM_ATOL)
        np.testing.assert_array_equal(pr[i], port.doc_rows[order])
        np.testing.assert_array_equal(pr[i], rr[i])
