"""The port's device mesh against the JAX package's, on the CPU.

The reference's tests run its mesh on 8 virtual CPU devices (conftest's
`xla_force_host_platform_device_count=8`); the port's counterpart is
`parallel.mesh.virtual_devices(8)`: 8 logical devices over the CPU, each
shard's work a launch of the plain versions, the combine
`mesh_combine_plain`. Held against the reference on the same inputs:

- the three builders (`sharded_agg_step`, `sharded_bm25_topk`,
  `sharded_query_step`) on tests/test_parallel.py's inputs; integers
  exactly, f32 planes and scores within RTOL / ATOL (the reference adds
  its psum in XLA's order, the port in shard order 0..M-1), top-k ids
  equal up to ties within that tolerance;
- `TestShardedSql`'s statements (tests/test_parallel.py), the mesh top-N
  and its under-filled shards (tests/test_device_agg.py), the collective
  join and the search merge, at mesh widths 2, 4 and 8;
- `mesh_combine`'s and `mesh_score_blocks`' plain versions against loops
  written out here;
- `sdb_device` / `sdb_device_cache` (`device_rows`, `device_cache_rows`)
  against the reference's under 8 devices.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenedb_tpu import parallel as rpar
from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.obs import device as robs
from serenedb_tpu.utils.config import REGISTRY as RSETTINGS
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.exec import shard as pshard
from serenedb_tpu_torch.obs import device as pobs
from serenedb_tpu_torch.ops import mesh_kernels as MK
from serenedb_tpu_torch.parallel import mesh as pmesh
from serenedb_tpu_torch.utils.config import REGISTRY as PSETTINGS

#: f32 tolerance against the reference: its psum adds in XLA's order,
#: the port's `mesh_combine` in shard order
RTOL, ATOL = 1e-5, 1e-6
#: SQL float aggregates (tests/test_parallel.py's own bound)
SQL_REL = 1e-4
CPU = torch.device("cpu")
WIDTHS = [2, 4, 8]


@pytest.fixture
def mesh8():
    """The port's 8-device virtual mesh over the CPU (restored after)."""
    with pmesh.virtual_devices(8):
        yield pmesh.make_mesh(8, base=CPU)


@pytest.fixture(scope="module")
def rmesh():
    assert len(jax.devices()) == 8
    return rpar.make_mesh(8)


def _delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in LAUNCHES.snapshot().items()
            if v != before.get(k, 0)}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the three builders --------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed", "no_int32_wrap"])
def test_sharded_agg_step_exact(mesh8, rmesh, case):
    rng = np.random.default_rng(0)
    if case == "mixed":
        vals = rng.integers(0, 2**30, (64, 128)).astype(np.int32)
        mask = rng.random((64, 128)) > 0.2
        lo, hi = 1000, 2**29
    else:
        vals = np.full((512, 128), 65535, dtype=np.int32)
        mask = np.ones((512, 128), dtype=bool)
        lo, hi = 0, 2**30
    rc, rp = rpar.sharded_agg_step(rmesh)(
        jnp.asarray(vals), jnp.asarray(mask), jnp.int32(lo), jnp.int32(hi))
    before = LAUNCHES.snapshot()
    pc, pp = pmesh.sharded_agg_step(mesh8)(*_t(vals, mask), lo, hi)
    assert int(pc) == int(rc)
    assert np.array_equal(pp.numpy(), np.asarray(rp))
    assert pmesh.combine_agg_partials(pp) == \
        rpar.combine_agg_partials(rp)
    assert _delta(before) == {"mesh_agg_partials.plain": 8,
                              "mesh_combine.plain": 1}


def _postings(seed: int, pad_row: int = -1):
    rng = np.random.default_rng(seed)
    p = 8 * 128
    flat_docs = np.sort(rng.integers(0, p, p)).astype(np.int32)
    flat_tfs = rng.integers(1, 5, p).astype(np.int32)
    norms = rng.integers(5, 50, p).astype(np.int32)
    gidx = np.arange(p, dtype=np.int32).reshape(-1, 128)
    if pad_row >= 0:
        gidx[pad_row, 40:] = -1
    block_term = (np.arange(p // 128) % 2).astype(np.int32)
    idf = np.asarray([1.7, 0.4], dtype=np.float32)
    return p, flat_docs, flat_tfs, norms, gidx, block_term, idf


@pytest.mark.parametrize("pad_row", [-1, 3])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_sharded_bm25_topk_matches_reference(mesh8, rmesh, k, pad_row):
    p, *arrays = _postings(1, pad_row)
    rs, rd = rpar.sharded_bm25_topk(rmesh, p, k)(
        *[jnp.asarray(a) for a in arrays], jnp.float32(20.0))
    before = LAUNCHES.snapshot()
    ps, pd = pmesh.sharded_bm25_topk(mesh8, p, k)(*_t(*arrays), 20.0)
    rs, rd = np.asarray(rs), np.asarray(rd)
    np.testing.assert_allclose(ps.numpy(), rs, rtol=RTOL, atol=ATOL)
    for j in np.flatnonzero(pd.numpy() != rd):
        # ids may differ only where scores tie within the tolerance
        assert np.isclose(rs, rs[j], rtol=RTOL, atol=ATOL).sum() > 1
    assert _delta(before) == {"mesh_score_blocks.plain": 8,
                              "mesh_combine.plain": 1,
                              "topk_rows.plain": 1}


def test_sharded_query_step_matches_reference(mesh8, rmesh):
    rng = np.random.default_rng(2)
    g = 16
    vals = rng.integers(-20, 100, (16, 128)).astype(np.int32)
    mask = rng.random((16, 128)) > 0.1
    codes = rng.integers(0, g, (16, 128)).astype(np.int32)
    p, flat_docs, flat_tfs, _n, gidx, block_term, _i = _postings(2, 5)
    args = (vals, mask, codes, flat_docs, flat_tfs, gidx, block_term)
    ref = rpar.sharded_query_step(rmesh, g)(*[jnp.asarray(a) for a in args])
    before = LAUNCHES.snapshot()
    got = pmesh.sharded_query_step(mesh8, g)(*_t(*args))
    counts, sums, scores = (np.asarray(r) for r in ref)
    assert np.array_equal(got[0].numpy(), counts)      # exact counts
    np.testing.assert_allclose(got[1].numpy(), sums, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), scores, rtol=RTOL,
                               atol=ATOL)
    assert got[2].shape == (p,)
    d = _delta(before)
    assert d["mesh_score_blocks.plain"] == 8
    assert d["mesh_combine.plain"] == 1             # one fused f32 launch


def test_shard_rows_pads(mesh8):
    out = pmesh.shard_rows(np.ones((13, 4)), mesh8)
    assert out.shape[0] % 8 == 0
    t = pmesh.shard_rows(torch.ones((13, 128), dtype=torch.bool), mesh8)
    assert t.shape == (16, 128) and not t[13:].any()


# -- mesh_combine / mesh_score_blocks plain versions ---------------------------


def test_mesh_combine_sums_in_shard_order():
    """f32 sums add shard 0, then 1, then 2...: (1e8 + 1) - 1e8 keeps the
    order's rounding."""
    stack = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    want = np.float32(1e8)
    for x in (1.0, -1e8, 1.0):
        want = np.float32(want + np.float32(x))
    got = MK.mesh_combine(stack, "sum")
    assert got.numpy().view(np.int32)[0] == \
        np.asarray([want]).view(np.int32)[0]


def test_mesh_combine_int64_exact_and_minmax():
    rng = np.random.default_rng(4)
    big = rng.integers(-2**62, 2**62, (8, 33)) // 8
    got = MK.mesh_combine(torch.from_numpy(big), "sum").numpy()
    assert np.array_equal(got, big.sum(0))
    ints = rng.integers(-2**31, 2**31 - 1, (5, 40)).astype(np.int32)
    t = torch.from_numpy(ints)
    assert np.array_equal(MK.mesh_combine(t, "min").numpy(), ints.min(0))
    assert np.array_equal(MK.mesh_combine(t, "max").numpy(), ints.max(0))
    u = ints.view(np.uint32)
    assert np.array_equal(MK.mesh_combine(t, "min", True).numpy(),
                          u.min(0).view(np.int32))
    assert np.array_equal(MK.mesh_combine(t, "max", True).numpy(),
                          u.max(0).view(np.int32))
    f = torch.tensor([[1.0, np.nan, 2.0], [0.5, 1.0, -3.0]],
                     dtype=torch.float32)
    lo = MK.mesh_combine(f, "min").numpy()
    assert lo[0] == 0.5 and np.isnan(lo[1]) and lo[2] == -3.0


def test_axis_combines_are_one_launch_a_call():
    """Fused, every 'sum', 'min' and 'max' output of a call (int64, f32,
    int32) is one launch; unfused, one launch an output."""
    outs = [[torch.tensor([s, 2 * s], dtype=torch.int64),
             torch.tensor([[s]], dtype=torch.int64),
             torch.tensor([0.5 * s], dtype=torch.float32),
             torch.tensor([s], dtype=torch.int32)] for s in range(1, 5)]
    kinds = ["sum", "sum", "sum", "max"]
    before = LAUNCHES.snapshot()
    got = pmesh.apply_axis_combines(outs, kinds, CPU, fuse_sums=True)
    assert _delta(before) == {"mesh_combine.plain": 1}
    assert got[0].tolist() == [10, 20] and got[1].tolist() == [[10]]
    assert got[2].tolist() == [5.0] and got[3].tolist() == [4]
    before = LAUNCHES.snapshot()
    again = pmesh.apply_axis_combines(outs, kinds, CPU)
    assert _delta(before) == {"mesh_combine.plain": 4}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    rows = pmesh.apply_axis_combines(outs, ["rows"] * 4, CPU)
    assert rows[0].tolist() == [1, 2, 2, 4, 3, 6, 4, 8]


def _loop(arrs, op: str, unsigned: bool = False) -> np.ndarray:
    """The combine written out: shard 0's value, then each shard in turn
    (NaN from any shard for f32 min/max; u32 order where unsigned)."""
    xs = [a.view(np.uint32) if unsigned else a for a in arrs]
    acc = xs[0].copy()
    for x in xs[1:]:
        if op == "sum":
            acc = acc + x
        else:
            f = np.minimum if op == "min" else np.maximum
            acc = f(acc, x)                  # NaN from either side
    if acc.dtype == np.float32 and op != "sum":
        acc[np.isnan(acc)] = np.float32(np.nan)
    return acc.view(arrs[0].dtype)


def _combine_data(rng, dtype: str, M: int, n: int) -> np.ndarray:
    """(M, n + 3): int64 past 2^31 in sum, f32 with NaN, int32 over the
    whole range (its u32 order differs from its signed one)."""
    shape = (M, n + 3)
    if dtype == "int64":
        return rng.integers(-2**40, 2**40, shape)
    if dtype == "float32":
        x = (rng.standard_normal(shape) * 1e3).astype(np.float32)
        x[rng.random(shape) < 0.05] = np.nan
        return x
    return rng.integers(-2**31, 2**31 - 1, shape).astype(np.int32)


def _bits(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else t
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
@pytest.mark.parametrize("n", [0, 1, 7, 4097])
def test_mesh_combine_parts_and_many_match_the_stack(M, dtype, n):
    """The parts form (views at odd offsets) and the many-segment form
    give the stack form's bits, which are the shard-order loop's; each
    form a launch a call, none for N = 0."""
    rng = np.random.default_rng(M * 100 + n)
    base = _combine_data(rng, dtype, M, n)
    views = [torch.from_numpy(base[s])[1 + s % 3:1 + s % 3 + n]
             for s in range(M)]
    stack = torch.stack(views)
    arrs = [v.numpy() for v in views]
    ops = [("sum", False), ("min", False), ("max", False)]
    if dtype == "int32":
        ops += [("min", True), ("max", True)]
    before = LAUNCHES.snapshot()
    many = MK.mesh_combine_many([(views, op, u) for op, u in ops])
    assert _delta(before) == ({"mesh_combine.plain": 1} if n else {})
    for (op, u), m in zip(ops, many):
        before = LAUNCHES.snapshot()
        st = MK.mesh_combine(stack, op, u)
        parts = MK.mesh_combine(views, op, u)
        assert _delta(before) == ({"mesh_combine.plain": 2} if n else {})
        want = _loop(arrs, op, u)
        for got in (st, parts, m):
            assert got.shape == (n,)
            assert np.array_equal(_bits(got), _bits(want)), (op, u)
    if dtype == "int64" and n > 1 and M > 1:
        assert np.abs(many[0].numpy()).max() > 2**31


def test_mesh_combine_launches_split_past_the_caps():
    """A call past COMBINE_SEGS segments or COMBINE_PTRS pointers is the
    fewest launches that fit, in order; an output past SEG_MAX elements
    is cut into pieces; the results are the one-launch results."""
    parts = [[torch.full((3,), float(s + i), dtype=torch.float32)
              for s in range(4)] for i in range(MK.COMBINE_SEGS + 12)]
    before = LAUNCHES.snapshot()
    got = MK.mesh_combine_many([(p, "sum") for p in parts])
    assert _delta(before) == {"mesh_combine.plain": 2}
    assert [g.tolist() for g in got] == \
        [[4.0 * i + 6.0] * 3 for i in range(len(parts))]
    segs = MK._segments([(p, "max") for p in parts])
    assert [len(x) for x in MK.combine_launches(segs)] == \
        [MK.COMBINE_SEGS, 12]
    wide = [([torch.zeros(1)] * 8, "sum", False)] * 40   # 320 pointers
    assert [len(x) for x in MK.combine_launches(wide)] == \
        [MK.COMBINE_PTRS // 8, 40 - MK.COMBINE_PTRS // 8]
    big = torch.zeros(1).expand(2 * MK.SEG_MAX + 5)      # no storage
    assert MK.combine_launches([([big, big], "sum", False)]) == \
        [[(0, 0, MK.SEG_MAX), (0, MK.SEG_MAX, MK.SEG_MAX),
          (0, 2 * MK.SEG_MAX, 5)]]
    with pytest.raises(ValueError):
        MK.mesh_combine([torch.zeros(1)] * (MK.COMBINE_PTRS + 1), "sum")
    with pytest.raises(ValueError):
        MK.mesh_combine([torch.zeros(2), torch.zeros(3)], "sum")


def test_combine_descriptor_words():
    """The host words csrc/mesh.cu's `mesh_combine` reads: the piece
    count, six words a piece (out, n, m, ptr0, type, op), then the
    shards' pointers in order; int32 min as u32 takes the U32 code."""
    a = [torch.zeros(5, dtype=torch.int32) for _ in range(3)]
    b = [torch.zeros(2, dtype=torch.int64) for _ in range(2)]
    segs = MK._segments([(a, "min", True), (b, "sum")])
    outs = [torch.empty(5, dtype=torch.int32),
            torch.empty(2, dtype=torch.int64)]
    (d,) = MK.combine_descriptors(segs, outs)
    assert d.tolist() == [2, outs[0].data_ptr(), 5, 3, 0, 3, 1,
                          outs[1].data_ptr(), 2, 2, 3, 1, 0] + \
        [p.data_ptr() for p in a + b]


def test_apply_axis_combines_matches_reference(mesh8, rmesh):
    """Mixed kinds and dtypes in one fused call against the reference's
    `apply_axis_combines` inside shard_map over its 8 CPU devices, on
    the same numpy inputs: integers, min/max (u32 included) and rows
    exactly, f32 sums within RTOL / ATOL (the reference adds in XLA's
    order, the port in shard order). No NaN here: XLA's CPU pmin / pmax
    drop one, where the port's combine (as `jnp.minimum`) returns NaN;
    the parts test holds the port's NaN rule."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from serenedb_tpu.parallel import mesh as rmesh_mod
    rng = np.random.default_rng(17)
    f = (rng.standard_normal((8, 37)) * 100).astype(np.float32)
    u = rng.integers(0, 2**32 - 1, (8, 19), dtype=np.uint64) \
        .astype(np.uint32)
    specs = [("sum", rng.integers(-2**20, 2**20, (8, 33)).astype(np.int32)),
             ("sum", f), ("min", f), ("max", f),
             ("max", rng.integers(-50, 50, (8, 1)).astype(np.int32)),
             ("min", u), ("max", u),
             ("rows", rng.integers(0, 9, (8, 5)).astype(np.int32)),
             ("sum", rng.integers(0, 2, (8, 130)).astype(np.int32))]
    kinds = [k for k, _ in specs]

    def core(*xs):
        return rmesh_mod.apply_axis_combines(xs, kinds, fuse_sums=True)
    prog = shard_map(core, mesh=rmesh,
                     in_specs=tuple(P(rmesh_mod.AXIS, None) for _ in specs),
                     out_specs=tuple(P() if k != "rows" else
                                     P(rmesh_mod.AXIS, None) for k in kinds))
    want = [np.asarray(r) for r in prog(*[jnp.asarray(a) for _, a in specs])]
    outs = [[torch.from_numpy(np.ascontiguousarray(
        a[s].view(np.int32) if a.dtype == np.uint32 else a[s]))
        for _, a in specs] for s in range(8)]
    uns = [a.dtype == np.uint32 for _, a in specs]
    before = LAUNCHES.snapshot()
    got = pmesh.apply_axis_combines(outs, kinds, CPU, fuse_sums=True,
                                    unsigned=uns)
    assert _delta(before) == {"mesh_combine.plain": 1}
    for (kind, a), g, w in zip(specs, got, want):
        g = g.numpy().view(np.uint32) if a.dtype == np.uint32 else g.numpy()
        w = w.reshape(-1) if kind == "rows" else w.reshape(g.shape)
        if kind == "sum" and a.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, w)


def test_mesh_score_blocks_adds_in_gidx_order():
    """Each doc's contributions added in gidx order from +0.0, padding
    skipped: a loop over the entries written out."""
    p, flat_docs, flat_tfs, norms, gidx, block_term, idf = _postings(7, 2)
    gidx = gidx[::-1].copy()                      # docs met out of order
    block_term = block_term[::-1].copy()
    for mode in ("bm25", "saturation"):
        plane = MK.mesh_score_blocks(*_t(flat_docs, flat_tfs, norms, gidx,
                                         block_term, idf), 20.0, p, mode)
        want = np.zeros(p, dtype=np.float32)
        f32 = np.float32
        for e, gi in enumerate(gidx.reshape(-1)):
            if gi < 0:
                continue
            d, tf = flat_docs[gi], f32(flat_tfs[gi])
            if mode == "saturation":
                c = tf / (tf + f32(1.2))
            else:
                w = idf[block_term[e // 128]]
                denom = tf + f32(1.2) * (f32(1.0) - f32(0.75) + f32(0.75) *
                                         f32(norms[d]) / f32(20.0))
                c = w * (f32(1.2) + f32(1.0)) * tf / max(denom, f32(1e-9))
            want[d] = f32(want[d] + f32(c))
        assert np.array_equal(plane.numpy().view(np.int32),
                              want.view(np.int32)), mode


# -- mesh_score_blocks' kernel order (csrc/mesh.cu), modelled in numpy ---------

_SORT_NONE = 0xFFFF


def _contribs(flat_docs, flat_tfs, norms, g, block_term, idf, W, avgdl,
              mode):
    """Each entry's contribution in f32, as the kernel computes it (-1.0
    for padding)."""
    f32 = np.float32
    valid = g >= 0
    gv = np.where(valid, g, 0)
    tf = flat_tfs[gv].astype(f32)
    if mode == "saturation":
        c = tf / (tf + f32(1.2))
    else:
        dl = norms[flat_docs[gv]].astype(f32)
        w = idf[block_term[np.arange(g.size) // W]]
        avg = f32(max(float(f32(avgdl)), 1e-9))
        denom = tf + f32(1.2) * (f32(1.0) - f32(0.75) + f32(0.75) * dl / avg)
        c = w * (f32(1.2) + f32(1.0)) * tf / np.maximum(denom, f32(1e-9))
    return np.where(valid, c, f32(-1.0)).astype(f32)


def _model_score_blocks(flat_docs, flat_tfs, norms, gidx, block_term, idf,
                        avgdl, ndocs, mode, plan=None):
    """mesh_score_blocks as its two kernels order the work: ms_bin_kernel
    (a slice at a time, rounds of 2,048 entries sorted stably by bin, each
    entry to its bin's cursor plus its rank, each bin's slice end to
    `ends`; the first pass writes every entry's record in entry order, so
    a slice already in bin order with no padding is bucketed by it and
    takes no round) and ms_tile_kernel (a
    (bin, docs range) at a time: the bin's runs slice by slice, each doc's
    entries added in that order from +0.0 by the thread that owns the
    doc's low 8 bits). Returns the plane, the buffer sizes the model used
    and each slice's kind (1: in place)."""
    g = np.ascontiguousarray(gidx).reshape(-1).astype(np.int64)
    E = g.size
    p = plan or MK.score_plan(E, ndocs)
    c = _contribs(flat_docs, flat_tfs, norms, g, block_term, idf,
                  max(gidx.shape[1], 1), avgdl, mode)
    doc = np.where(g >= 0, flat_docs[np.where(g >= 0, g, 0)], -1)
    doc = np.where((doc >= 0) & (doc < ndocs), doc, -1)
    stage_doc = np.full(E, -1, np.int64)
    stage_val = np.zeros(E, np.float32)
    ends = np.zeros((p.bins, p.slices), np.int64)
    kind = np.zeros(p.slices, np.int64)
    used = 0
    for b in range(p.slices):
        lo, hi = b * p.slice_len, min(E, (b + 1) * p.slice_len)
        d = doc[lo:hi]
        kind[b] = d.size > 0 and bool((d >= 0).all()) and \
            bool((np.diff(d >> p.shift) >= 0).all())
        hist = np.bincount(d[d >= 0] >> p.shift, minlength=p.bins)
        assert hist.size == p.bins <= MK.BINS_MAX
        cursor = np.cumsum(hist) - hist
        for r in range(lo, hi, MK.SLICE_MIN):
            rd = doc[r:min(hi, r + MK.SLICE_MIN)]
            key = np.where(rd >= 0, rd >> p.shift, _SORT_NONE)
            order = np.argsort(key, kind="stable")
            sk = key[order]
            first = np.searchsorted(sk, sk, side="left")
            for pos, (k, src) in enumerate(zip(sk, order)):
                if k == _SORT_NONE:
                    continue
                at = lo + cursor[k] + pos - first[pos]
                assert lo <= at < hi and stage_doc[at] == -1
                assert not kind[b] or at == r + src      # in place
                stage_doc[at], stage_val[at] = rd[src], c[r + src]
                used = max(used, at + 1)
            cursor += np.bincount(sk[sk != _SORT_NONE], minlength=p.bins)
        ends[:, b] = cursor
    plane = np.full(ndocs, np.nan, np.float32)
    for item in range(p.bins * p.subs):
        t, sub = divmod(item, p.subs)
        d0 = (t << p.shift) + (sub << p.acc_shift)
        if d0 >= ndocs:
            continue
        nd = min(1 << p.acc_shift, ndocs - d0)
        beg = ends[t - 1] if t else np.zeros(p.slices, np.int64)
        seq = np.concatenate([np.arange(j * p.slice_len + beg[j],
                                        j * p.slice_len + ends[t, j])
                              for j in range(p.slices)]).astype(np.int64)
        acc = np.zeros(nd, np.float32)
        dl = stage_doc[seq] - d0
        for q in np.flatnonzero((dl >= 0) & (dl < nd)):   # in gidx order
            acc[dl[q]] = np.float32(acc[dl[q]] + stage_val[seq[q]])
        plane[d0:d0 + nd] = acc
    return plane, {"stage": 8 * used, "ends": 4 * ends.size}, kind


def _score_case(case: str):
    """(flat_docs, flat_tfs, norms, gidx, block_term, idf, ndocs) of one
    shape the kernel must take."""
    rng = np.random.default_rng(len(case))
    nd = {"skewed": 3_000, "unsorted": 7_000, "edges": 2 * 2048 + 5,
          "sparse": 300_000, "padding": 5_000, "empty": 5_000,
          "inplace": 200_000}[case]
    P = 40_000
    flat_docs = rng.integers(0, nd, P).astype(np.int32)
    if case == "skewed":
        flat_docs[rng.random(P) < 0.3] = 17          # ~12,000 in one doc
    if case == "edges":
        flat_docs = rng.choice(np.asarray([0, 2047, 2048, 4095, 4096,
                                           nd - 1], np.int32), P)
    flat_tfs = rng.integers(1, 40, P).astype(np.int32)
    norms = rng.integers(1, 300, nd).astype(np.int32)
    rows = {"empty": 0, "sparse": 20}.get(case, 200)
    g = rng.integers(0, P, (rows, 128)).astype(np.int32)
    if case == "inplace":                        # one posting list
        flat_docs = np.sort(flat_docs)
        g = (np.arange(rows * 128) % P).reshape(rows, 128).astype(np.int32)
    elif case != "unsorted":
        g = np.sort(g, axis=None).reshape(rows, 128)
    if case != "inplace":
        g[rng.random(g.shape) < 0.1] = -1
    if case == "padding":
        g[:] = -1
    block_term = rng.integers(0, 3, rows).astype(np.int32)
    idf = (rng.random(3) * 3).astype(np.float32)
    return flat_docs, flat_tfs, norms, g, block_term, idf, nd


def _plans(E: int, nd: int) -> dict:
    """The wrapper's plan, and two that reach what small inputs do not:
    several rounds a slice, and a bin split over tile blocks."""
    p = MK.score_plan(E, nd)
    rounds = p._replace(slices=3, slice_len=max(1, -(-E // 3)),
                        ends_off=0, bytes=0)
    shift = 11 + (-(-nd >> 11) > 8)       # several bins, as large planes
    split = p._replace(shift=shift, bins=-(-nd >> shift),
                       acc_shift=shift - 2, subs=4, ends_off=0, bytes=0)
    return {"wrapper": p, "rounds": rounds, "split": split}


@pytest.mark.parametrize("case", ["skewed", "unsorted", "edges", "sparse",
                                  "padding", "empty", "inplace"])
@pytest.mark.parametrize("mode", ["bm25", "saturation"])
@pytest.mark.parametrize("plan", ["wrapper", "rounds", "split"])
def test_mesh_score_blocks_kernel_order_matches_plain(case, mode, plan):
    """The kernel's order, modelled in numpy (entries bucketed stably by
    bin a slice at a time, each bin read slice by slice, each round's
    same-doc entries added in order), gives the plain version's plane bit
    for bit: skewed, unsorted, bin-edge, sparse, all-padding and empty
    inputs, under the wrapper's plan and two that split slices into
    rounds and bins over blocks."""
    fd, ft, nm, g, bt, idf, nd = _score_case(case)
    want = MK.mesh_score_blocks(*_t(fd, ft, nm, g, bt, idf), 31.5, nd,
                                mode).numpy()
    p = _plans(g.size, nd)[plan]
    got, used, kind = _model_score_blocks(fd, ft, nm, g, bt, idf, 31.5, nd,
                                          mode, p)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if plan == "wrapper":
        assert used["stage"] <= p.ends_off
        assert p.ends_off + used["ends"] <= p.bytes
    if case in ("edges", "padding", "empty"):
        assert not kind.any()                    # unsorted or padding
    if case == "inplace":
        assert kind.all()


@pytest.mark.parametrize("E,ndocs,slices,shift,subs", [
    (0, 1, 1, 2, 1),
    (1, 5, 1, 2, 1),
    (2048, 2048, 1, 2, 1),
    (2049, 2049, 2, 3, 1),
    (300_000, 3_001, 147, 3, 1),                 # E far above ndocs
    (597_888, 8_000_512, 256, 13, 1),            # a BM25 shard, phase 21
    (29_360_128, 117_440_512, 256, 13, 1),       # a saturation shard
    (10_000, 2**31 - 1, 5, 17, 16),
])
def test_score_plan_sizes(E, ndocs, slices, shift, subs):
    """score_plan: at most SLICES_MAX slices of at least SLICE_MIN
    entries; bins of 2^13 docs, smaller on a plane that would make fewer
    than BINS_FEW of them (down to 4 docs), larger past BINS_MAX, covering
    the plane; tile blocks of at most 2^13 docs; scratch of 8 bytes an
    entry and 4 a (bin, slice), not O(ndocs): under 0.4 GB at the
    saturation shard."""
    p = MK.score_plan(E, ndocs)
    assert (p.slices, p.shift, p.subs) == (slices, shift, subs)
    assert p.slices * p.slice_len >= E
    assert p.bins <= MK.BINS_MAX and p.bins << p.shift >= ndocs
    assert (p.bins - 1) << p.shift < ndocs
    assert p.subs << p.acc_shift == 1 << p.shift
    assert p.acc_shift <= MK.ACC_SHIFT
    assert p.bins > MK.BINS_FEW // 2 or p.shift in (MK.BIN_SHIFT_MIN,
                                                     MK.ACC_SHIFT)
    assert p.bytes == -(-8 * E // 16) * 16 + \
        -(-4 * p.slices * p.bins // 16) * 16
    if E == 29_360_128:
        assert p.bytes < 0.4e9


def test_mesh_agg_partials_refuses_past_an_int32_count():
    """R * 128 lanes must fit the int32 count: refused past it, on any
    device (a stride-0 view, no memory)."""
    R = 2**31 // 128
    vals = torch.zeros(1, 128, dtype=torch.int32).expand(R, 128)
    mask = torch.ones(1, 128, dtype=torch.bool).expand(R, 128)
    with pytest.raises(ValueError, match="int32"):
        MK.mesh_agg_partials(vals, mask, 0, 1)
    c, p = MK.mesh_agg_partials(vals[:1000], mask[:1000], 0, 1)
    assert int(c) == 128_000 and p.shape == (1000, 2)


# -- SQL over the mesh (tests/test_parallel.py TestShardedSql) -----------------


def _sql_db(db):
    c = db.connect()
    c.execute("CREATE TABLE st (k INT, v INT, f DOUBLE, body TEXT)")
    rng = random.Random(5)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "common"]
    c.execute("INSERT INTO st VALUES " + ", ".join(
        f"({rng.randint(0, 9)}, {rng.randint(-500, 500)}, "
        f"{rng.random() * 10:.4f}, "
        f"'{' '.join(rng.choices(words, k=6))}')" for _ in range(20000)))
    c.execute("SET serene_result_cache = off")
    return c


@pytest.fixture(scope="module")
def sql_pair():
    rc = _sql_db(RDatabase(None))
    rc.execute("SET serene_device = 'tpu'")
    pc = _sql_db(Database(device="cpu"))
    pc.execute("SET serene_device = 'gpu'")
    return rc, pc


def _close(got, want) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if abs(a - b) > SQL_REL * max(abs(b), 1e-9):
                    return False
            elif a != b:
                return False
    return True


SQL_QUERIES = [
    ("SELECT k, count(*), sum(v), min(v), max(v) FROM st "
     "WHERE v > -300 GROUP BY k ORDER BY k", True),
    ("SELECT count(*), sum(v), min(v), max(v) FROM st WHERE k < 7", True),
    ("SELECT k, avg(f), min(f), max(f) FROM st GROUP BY k ORDER BY k",
     False),
    ("SELECT k, count(DISTINCT v) FROM st GROUP BY k ORDER BY k", True),
]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("qi", range(len(SQL_QUERIES)))
def test_sql_aggregates_over_the_mesh(sql_pair, width, qi):
    """serene_mesh = width: the port's `agg_scan` once a shard, combined
    by `mesh_combine`; integer aggregates equal to the reference's mesh,
    float ones within its test's bound."""
    rc, pc = sql_pair
    q, exact = SQL_QUERIES[qi]
    try:
        with pmesh.virtual_devices(8):
            for c in (rc, pc):
                c.execute(f"SET serene_mesh = {width}")
            before = LAUNCHES.snapshot()
            got = pc.execute(q).rows()
            d = _delta(before)
            want = rc.execute(q).rows()
    finally:
        for c in (rc, pc):
            c.execute("SET serene_mesh = 0")
    assert got == want if exact else _close(got, want)
    assert d["agg_scan.plain"] == width
    assert d["mesh_combine.plain"] >= 1


def test_mesh_larger_than_devices_takes_one_device(sql_pair):
    rc, pc = sql_pair
    q = "SELECT count(*), sum(v) FROM st WHERE v > 0"
    try:
        with pmesh.virtual_devices(8):
            for c in (rc, pc):
                c.execute("SET serene_mesh = 4096")
            before = LAUNCHES.snapshot()
            assert pc.execute(q).rows() == rc.execute(q).rows()
            d = _delta(before)
    finally:
        for c in (rc, pc):
            c.execute("SET serene_mesh = 0")
    assert d.get("agg_scan.plain") == 1 and "mesh_combine.plain" not in d


def test_bm25_sql_over_the_mesh(sql_pair):
    rc, pc = sql_pair
    for c in (rc, pc):
        c.execute("CREATE INDEX ON st USING inverted (body)")
    q = ("SELECT k, bm25(body, 'common alpha') AS s FROM st "
         "WHERE body @@ 'common alpha' ORDER BY s DESC, k LIMIT 10")
    try:
        single = rc.execute(q).rows()
        with pmesh.virtual_devices(8):
            for c in (rc, pc):
                c.execute("SET serene_mesh = 8")
            got = pc.execute(q).rows()
    finally:
        for c in (rc, pc):
            c.execute("SET serene_mesh = 0")
    assert [r[0] for r in got] == [r[0] for r in single]
    for g, s in zip(got, single):
        assert abs(g[1] - s[1]) < 1e-3


# -- the mesh top-N (tests/test_device_agg.py) ---------------------------------


@pytest.fixture(scope="module")
def topn_pair():
    out = []
    for db, dev in ((RDatabase(None), "tpu"), (Database(device="cpu"),
                                                "gpu")):
        c = db.connect()
        c.execute("CREATE TABLE h (k INT, v INT, d DATE)")
        rng = random.Random(9)
        c.execute("INSERT INTO h VALUES " + ", ".join(
            f"({rng.randint(0, 9)}, {rng.randint(-500, 500)}, "
            f"DATE '2020-01-{rng.randint(1, 28):02d}')"
            for _ in range(20000)))
        c.execute("CREATE TABLE small (v INT)")
        c.execute("INSERT INTO small VALUES " + ", ".join(
            f"({i * 3 - 50})" for i in range(100)))
        c.execute("SET serene_result_cache = off")
        c.execute(f"SET serene_device = '{dev}'")
        out.append(c)
    return out


TOPN_QUERIES = ["SELECT * FROM h ORDER BY v DESC LIMIT 10",
                "SELECT * FROM h ORDER BY v LIMIT 25",
                "SELECT k, d FROM h ORDER BY d LIMIT 12",
                # under-filled shards: 100 rows over 8 shards of 128
                "SELECT v FROM small ORDER BY v DESC LIMIT 10",
                "SELECT v FROM small ORDER BY v LIMIT 10"]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("q", TOPN_QUERIES)
def test_topn_over_the_mesh(topn_pair, width, q):
    rc, pc = topn_pair
    try:
        with pmesh.virtual_devices(8):
            for c in (rc, pc):
                c.execute(f"SET serene_mesh = {width}")
            before = LAUNCHES.snapshot()
            got = pc.execute(q).rows()
            d = _delta(before)
            want = rc.execute(q).rows()
    finally:
        for c in (rc, pc):
            c.execute("SET serene_mesh = 0")
    assert got == want
    assert d == {"topn_scan.plain": width}


# -- the sharded tier: the collective join and the search merge ----------------


@pytest.fixture(scope="module")
def shard_pair():
    from test_torch_shard import _pair
    return _pair()


@pytest.mark.parametrize("shards", WIDTHS)
def test_collective_join_over_the_mesh(shard_pair, shards):
    """serene_shards = width, the device combine: `data_mesh(S)` spans
    min(S, 8) devices, one `join_probe` a mesh device, the accumulators
    combined by `mesh_combine`; rows equal the reference's collective."""
    from test_multichip import JOIN_Q, QUERIES
    rc, pc = shard_pair
    try:
        with pmesh.virtual_devices(8):
            for c in (rc, pc):
                c.execute(f"SET serene_shards = {shards}")
                c.execute("SET serene_shard_combine = device")
            for q in QUERIES + [JOIN_Q]:
                pc.execute(q)
                before = LAUNCHES.snapshot()
                got = repr(pc.execute(q).rows())
                d = _delta(before)
                assert got == repr(rc.execute(q).rows()), (q, shards)
                if "join_probe.plain" in d:
                    assert d["join_probe.plain"] > 1
                    assert d["mesh_combine.plain"] >= 1
    finally:
        for c in (rc, pc):
            c.execute("SET serene_shards = 1")
            c.execute("SET serene_shard_combine = auto")


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
@pytest.mark.parametrize("k", [1, 7, 60])
def test_search_merge_over_the_mesh(n_shards, k):
    """The sharded search merge at mesh width min(S, 8): one `merge_topk`
    a mesh device and one over their results, bit for bit the
    reference's merge (ties and -0.0 included)."""
    from serenedb_tpu.search.searcher import _device_merge_topk as rmerge
    from serenedb_tpu_torch.search.searcher import _device_merge_topk
    from test_torch_shard import _bits, _crafted
    seg_outs, bases = _crafted()
    ref = rmerge(seg_outs, bases, 1, k, n_shards)
    with pmesh.virtual_devices(8):
        before = LAUNCHES.snapshot()
        got = _device_merge_topk(seg_outs, bases, 1, k, n_shards,
                                 device="cpu")
        d = _delta(before)
    assert np.array_equal(got[0][1], ref[0][1])
    assert np.array_equal(_bits(got[0][0]), _bits(ref[0][0]))
    m = min(n_shards, len(seg_outs), 8)
    assert d == {"merge_topk.plain": m + 1}


def test_auto_combine_follows_the_mesh():
    """'auto' resolves to device while more than one device is in use,
    and back to host once the virtual mesh is gone."""
    prior = PSETTINGS.get_global("serene_shard_combine")
    try:
        PSETTINGS.set_global("serene_shard_combine", "auto")
        with pmesh.virtual_devices(8):
            assert pshard.combine_mode(None) == "device"
            assert pmesh.shard_devices(4, base=CPU) == \
                [(s, CPU) for s in range(4)]
            assert pmesh.data_mesh_width(4, base=CPU) == 4
        assert pshard.combine_mode(None) == "host"
        assert pmesh.shard_devices(4, base=CPU) is None
    finally:
        PSETTINGS.set_global("serene_shard_combine", prior)


# -- the per-device relations --------------------------------------------------


def test_device_rows_match_the_reference_under_8_devices(sql_pair):
    rc, pc = sql_pair
    prior = (PSETTINGS.get_global("serene_device_telemetry"),
             RSETTINGS.get_global("serene_device_telemetry"))
    try:
        PSETTINGS.set_global("serene_device_telemetry", True)
        RSETTINGS.set_global("serene_device_telemetry", True)
        with pmesh.virtual_devices(8):
            pc.execute("SET serene_mesh = 8")
            pobs.LEDGER.reset()
            pc.execute("SELECT k, count(*) FROM st GROUP BY k").rows()
            prow = pobs.device_rows(base=CPU)
            pcache = pobs.device_cache_rows()
            q = pc.execute("SELECT * FROM sdb_device")
            names = q.names
            nrel = len(q.rows())
        rc.execute("SELECT k, count(*) FROM st GROUP BY k").rows()
        rrow, rcache = robs.device_rows(), robs.device_cache_rows()
        rq = rc.execute("SELECT * FROM sdb_device")
        assert names == rq.names
        assert len(prow) == len(rrow) == nrel == 8
        assert set(prow[0]) == set(rrow[0])
        assert [r["device"] for r in prow] == list(range(8))
        # each logical device ran its shard: one launch a device
        assert all(r["dispatches"] >= 1 for r in prow)
        assert {"table", "column", "bytes", "devices", "hits"} <= \
            set(pcache[0]) if pcache else True
        assert rcache is not None and \
            pc.execute("SELECT * FROM sdb_device_cache").names == \
            rc.execute("SELECT * FROM sdb_device_cache").names
    finally:
        pc.execute("SET serene_mesh = 0")
        PSETTINGS.set_global("serene_device_telemetry", prior[0])
        RSETTINGS.set_global("serene_device_telemetry", prior[1])
