"""A scan statement split across launches (the port's device tier).

The scan kernels (`agg_scan`, `join_probe`, `topn_scan`) interpret
postfix programs on a stack of `MAX_STACK` (8) entries, from a descriptor
of at most 16 column slots, 8 key plans, 8 predicates, 16 aggregates and
192 ops a launch. The reference's XLA has no such caps: it traces any
expression into its one program (serenedb_tpu/exec/device.py:60). A
statement inside the caps runs as one launch, exactly as before; one past
them is planned here into a `Split`, which the runners below execute
chunk by chunk in place of the one launch:

1. derived tiles: subtrees cut off a program that needs a deeper stack,
   more columns or more ops than a launch has, bottom up until what is
   left fits (a subtree of depth <= 8, its own columns and ops within a
   launch's). Each is a derive pass whose tile the later launches read
   as an ordinary column slot: the value the subtree would have pushed,
   so the programs above it are unchanged;
2. mask passes: predicate conjuncts (a WHERE splits losslessly at its
   top-level ANDs) that do not fit the scan launch, each narrowing the
   row mask;
   the derive passes, then the mask passes, are one `scan_eval` launch a
   chunk (`Split.prep`), which writes only the derived tiles a scan
   launch reads (a later pass reads the others where the launch keeps
   them) and the narrowed row mask; passes that read more than the
   launch's MAX_INPUTS (128) slots chain launches in plan order, a
   later one reading the earlier ones' tiles and row mask;
3. the scan launches: the aggregates in groups that fit (at most 16 a
   launch, 16 columns with the key columns, 192 ops), each one launch of
   the scan kernel with the narrowed row mask and the same group codes,
   and with the predicates still left when there is one launch; the
   outputs go back in the statement's order (the row counts are the
   first launch's: every launch counts the same rows).

An f32 sum adds in the order of the regime that the whole statement's
spec gives (`ScanSpec.force_global`), so how the aggregates are grouped
never changes a sum. Derived and mask tiles live for one chunk's
launches (2,097,152 rows: 8 MB an int32 tile) and never enter the
device cache. A plan depends on the spec alone, so it caches with it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from ..ops import agg_kernels as K
from ..ops import join_kernels as J
from ..ops import scan_kernels as S
from ..ops import topn_kernels as TK
from .device import NotCompilable

_NULLARY = {K.OP_COL, K.OP_I32, K.OP_F32, K.OP_NULL}
_BINARY = {K.OP_AND, K.OP_OR, K.OP_CMP_I, K.OP_CMP_F, K.OP_ADD_I,
           K.OP_SUB_I, K.OP_MUL_I, K.OP_ADD_F, K.OP_SUB_F, K.OP_MUL_F,
           K.OP_GATE}
_FLOAT_OPS = {K.OP_F32, K.OP_I2F, K.OP_ADD_F, K.OP_SUB_F, K.OP_MUL_F}
_INT_OPS = {K.OP_I32, K.OP_NULL, K.OP_F2I, K.OP_ADD_I, K.OP_SUB_I,
            K.OP_MUL_I, K.OP_SHRA, K.OP_SHRL, K.OP_ANDI, K.OP_NVL}
#: the column tile a derived value of each type is stored in (a boolean
#: as 0/1 int8, read back through OP_TOBOOL_I)
_STORE = {"f": K.COL_F32, "i8": K.COL_I8, "b": K.COL_I8, "i": K.COL_I32}


class _Node:
    """A program as a tree: one op and its operands, with the stack depth,
    op count and column slots of the subtree."""

    __slots__ = ("op", "arg", "imm", "kids", "depth", "n_ops", "cols")

    def __init__(self, op: int, arg: int, imm: int, kids: tuple = ()):
        self.op, self.arg, self.imm, self.kids = op, arg, imm, kids
        if not kids:
            self.depth, self.n_ops = 1, 1
            self.cols = frozenset((arg,)) if op == K.OP_COL else frozenset()
        elif len(kids) == 1:
            k = kids[0]
            self.depth, self.n_ops, self.cols = k.depth, k.n_ops + 1, k.cols
        else:
            a, b = kids
            self.depth = max(a.depth, 1 + b.depth)
            self.n_ops = a.n_ops + b.n_ops + 1
            self.cols = a.cols | b.cols

    def postfix(self, slot_of=None) -> tuple:
        """The program, its column slots renumbered by `slot_of`."""
        out: list = []
        stack = [(self, False)]
        while stack:
            n, done = stack.pop()
            if done or not n.kids:
                arg = slot_of[n.arg] if slot_of is not None and \
                    n.op == K.OP_COL else n.arg
                out.append((n.op, arg, n.imm))
                continue
            stack.append((n, True))
            stack.extend((k, False) for k in reversed(n.kids))
        return tuple(out)


def parse(ops) -> _Node:
    """The tree of a postfix program."""
    stack: list = []
    for op, arg, imm in ops:
        if op in _NULLARY:
            stack.append(_Node(op, arg, imm))
        elif op in _BINARY:
            b, a = stack.pop(), stack.pop()
            stack.append(_Node(op, arg, imm, (a, b)))
        else:
            stack.append(_Node(op, arg, imm, (stack.pop(),)))
    if len(stack) != 1:
        raise ValueError("malformed program")
    return stack[0]


def stack_depth(ops) -> int:
    return parse(ops).depth if ops else 0


def _conjuncts(n: _Node) -> list:
    """A predicate's top-level AND operands (a row passes where each is
    TRUE, exactly where the whole is)."""
    if n.op == K.OP_AND:
        return _conjuncts(n.kids[0]) + _conjuncts(n.kids[1])
    return [n]


def _type_of(n: _Node, slot_type) -> str:
    """The stack type of a subtree's value: 'b', 'i8', 'i' or 'f' (the
    types exec/device.compile_expr gave its ops)."""
    if n.op == K.OP_COL:
        return slot_type(n.arg)
    if n.op in _FLOAT_OPS:
        return "f"
    if n.op in _INT_OPS:
        return "i"
    if n.op == K.OP_WRAP8:
        return "i8"
    if n.op == K.OP_GATE:
        return _type_of(n.kids[0], slot_type)
    return "b"


@dataclass
class Launch:
    """One scan launch of a Split: its input slots, its kernel spec over
    them and the statement positions of its aggregates; for a probe
    launch of a RIGHT/FULL join, also the build slots its unmatched pass
    reads and that pass's spec over them."""
    slots: list
    spec: object
    positions: tuple
    bslots: Optional[list] = None
    uspec: Optional[J.UnmatchedSpec] = None


@dataclass
class Split:
    """A statement past one launch: its input columns' decode (the base
    slots), its derive and mask passes as scan_eval launches (each the
    slots it reads and its spec; one launch, none where there is no
    pass, more only where the passes read past MAX_INPUTS slots), the scan
    launches, the statement's group count and aggregates (which
    fix its outputs), every slot's decode (a derived tile takes the next
    slot after the base ones), each aggregate's program as fitted over
    those slots (None for a presence grid), and for a probe Split of a
    RIGHT/FULL join the build side's plan."""
    col_kinds: list
    col_offsets: list
    prep: list
    launches: list
    G: int = 1
    aggs: list = None
    slot_kinds: list = None
    slot_offsets: list = None
    progs: list = None
    build: object = None


class _Fitter:
    """Cuts subtrees into derived tiles until every program fits."""

    def __init__(self, col_kinds, col_offsets):
        self.kinds, self.offs = list(col_kinds), list(col_offsets)
        self.n_base = len(self.kinds)
        self.derived: list = []        # (slot, the subtree it holds)
        self._slot_of_prog: dict = {}

    def slot_type(self, s: int) -> str:
        return {K.COL_F32: "f", K.COL_I8: "i8"}.get(self.kinds[s], "i")

    def _atom(self, n: _Node) -> bool:
        """A leaf, or a derived tile's read: nothing left to cut."""
        return not n.kids or (n.op == K.OP_TOBOOL_I and
                              n.kids[0].op == K.OP_COL and
                              n.kids[0].arg >= self.n_base)

    def derive(self, n: _Node) -> _Node:
        """A derived slot for subtree n (one per distinct program) and the
        read that stands for it."""
        t = _type_of(n, self.slot_type)
        prog = n.postfix()
        slot = self._slot_of_prog.get(prog)
        if slot is None:
            slot = len(self.kinds)
            self.kinds.append(_STORE[t])
            self.offs.append(0)
            self.derived.append((slot, n))
            self._slot_of_prog[prog] = slot
        read = _Node(K.OP_COL, slot, 0)
        return _Node(K.OP_TOBOOL_I, 0, 0, (read,)) if t == "b" else read

    def fit(self, n: _Node, cap_cols: int, cap_ops: int) -> _Node:
        """n with subtrees cut until its stack is at most MAX_STACK deep
        and it reads at most cap_cols slots in at most cap_ops ops."""
        if not n.kids:
            return n
        kids = [self.fit(k, cap_cols, cap_ops) for k in n.kids]
        out = _Node(n.op, n.arg, n.imm, tuple(kids))
        while out.depth > K.MAX_STACK or len(out.cols) > cap_cols or \
                out.n_ops > cap_ops:
            cand = [i for i, k in enumerate(kids) if not self._atom(k)]
            if not cand:
                raise NotCompilable("program does not fit a launch",
                                    "device_descriptor")
            if out.depth > K.MAX_STACK:
                i = len(kids) - 1      # the right operand sits one higher
            else:
                i = max(cand, key=lambda j: (len(kids[j].cols),
                                             kids[j].n_ops))
            kids[i] = self.derive(kids[i])
            out = _Node(n.op, n.arg, n.imm, tuple(kids))
        return out

    def prepare(self, preds: list, stored: set) -> list:
        """The derive passes, then the predicate trees as mask passes, as
        scan_eval launches in plan order, [(the slots it reads, its
        EvalSpec)]: one launch, or, where the passes read more than the
        MAX_INPUTS slots a launch takes, as many as they need, each
        reading the tiles of the earlier ones that it needs and the row
        mask they narrowed. A derived tile is stored where a slot of
        `stored` holds it or a later launch reads it."""
        groups, cur, reads = [], [], set()
        for slot, n in [(s, n) for s, n in self.derived] + \
                [(None, n) for n in preds]:
            made = {s for s, _n in cur}
            need = reads | {s for s in n.cols if s not in made}
            if cur and len(need) > S.MAX_INPUTS:
                groups.append((cur, reads))
                cur, need = [], set(n.cols)
            cur.append((slot, n))
            reads = need
        if cur:
            groups.append((cur, reads))
        stored = stored | {s for _g, r in groups for s in r
                           if s >= self.n_base}
        out = []
        for passes, reads in groups:
            slots = sorted(reads)
            loc = {s: i for i, s in enumerate(slots)}
            derived = [(s, n) for s, n in passes if s is not None]
            loc.update((s, len(slots) + k)
                       for k, (s, _n) in enumerate(derived))
            out.append((slots, S.EvalSpec(
                [self.kinds[s] for s in slots], [self.offs[s] for s in slots],
                [S.Derive(n.postfix(loc), self.kinds[s], s in stored)
                 for s, n in derived],
                [n.postfix(loc) for s, n in passes if s is None])))
        return out

    def local(self, slots: list) -> tuple[dict, list, list]:
        loc = {s: i for i, s in enumerate(slots)}
        return loc, [self.kinds[s] for s in slots], \
            [self.offs[s] for s in slots]


class _Bin:
    """One launch being filled: its slots and ops, and those of the build
    side its unmatched pass reads (RIGHT/FULL), its items and
    predicates."""

    def __init__(self, cols, bcols=frozenset(), b_ops: int = 0):
        self.cols, self.n_ops = set(cols), 0
        self.bcols, self.b_ops = set(bcols), b_ops
        self.items, self.preds = [], []

    def takes(self, n_items: int, cap_items: int, cols, n_ops: int,
              bcols=frozenset(), b_ops: int = 0) -> bool:
        return n_items < cap_items and \
            len(self.cols | cols) <= K.MAX_COLS and \
            self.n_ops + n_ops <= K.MAX_OPS and \
            len(self.bcols | bcols) <= K.MAX_COLS and \
            self.b_ops + b_ops <= K.MAX_OPS

    def add(self, cols, n_ops: int, bcols=frozenset(), b_ops: int = 0):
        self.cols |= cols
        self.n_ops += n_ops
        self.bcols |= bcols
        self.b_ops += b_ops


def _pack(items: list, fixed_cols: frozenset, cap_items: int,
          bfixed: frozenset = frozenset(), bfixed_ops: int = 0) -> list:
    """First-fit of items (cols, n_ops[, build cols, build ops]), in
    order, into launches that each read fixed_cols (and bfixed) too."""
    bins: list = []
    for idx, item in enumerate(items):
        for b in bins:
            if b.takes(len(b.items), cap_items, *item):
                break
        else:
            b = _Bin(fixed_cols, bfixed, bfixed_ops)
            bins.append(b)
        b.add(*item)
        b.items.append(idx)
    return bins or [_Bin(fixed_cols, bfixed, bfixed_ops)]


def _fits(col_kinds, keys, preds, progs, n_aggs: int) -> bool:
    """Whether one launch takes the statement as it is."""
    return len(col_kinds) <= K.MAX_COLS and len(keys) <= K.MAX_KEYS and \
        len(preds) <= K.MAX_PREDS and n_aggs <= K.MAX_AGGS and \
        sum(map(len, preds)) + sum(map(len, progs)) <= K.MAX_OPS and \
        all(stack_depth(p) <= K.MAX_STACK for p in list(preds) + progs)


def _split_preds(f: _Fitter, preds, bins: list, keep: bool = True) -> list:
    """The predicates as fitted conjuncts: kept in the one launch while
    it takes them (with `keep`); the rest, the mask passes', returned."""
    conj = [f.fit(c, K.MAX_COLS, K.MAX_OPS)
            for p in preds for c in _conjuncts(parse(p))]
    rest = []
    for c in conj:
        b = bins[0]
        if keep and len(bins) == 1 and \
                b.takes(len(b.preds), K.MAX_PREDS, c.cols, c.n_ops):
            b.add(c.cols, c.n_ops)
            b.preds.append(c)
        else:
            rest.append(c)
    return rest


def _fit_items(f: _Fitter, progs, fixed_cols: frozenset) -> list:
    """Each aggregate program (None: reads no program) fitted to share a
    launch with the fixed columns."""
    cap = K.MAX_COLS - len(fixed_cols)
    return [None if p is None else f.fit(parse(p), cap, K.MAX_OPS)
            for p in progs]


def _fold_keys(f: _Fitter, keys: list, G: int) -> list:
    """The key plans, or past MAX_KEYS one derived key: the direct code
    itself (each key's code, NULL the key's last, times the sizes after
    it: the groups in the same order), read as one key of size G."""
    if len(keys) <= K.MAX_KEYS:
        return list(keys)
    code = None
    for kind, slot, lo, size in keys:
        c = _Node(K.OP_COL, slot, 0)
        if kind == K.KEY_INT:
            c = _Node(K.OP_SUB_I, 0, 0, (c, _Node(K.OP_I32, 0, lo)))
        c = _Node(K.OP_NVL, 0, size - 1, (c,))
        code = c if code is None else _Node(K.OP_ADD_I, 0, 0, (
            _Node(K.OP_MUL_I, 0, 0, (code, _Node(K.OP_I32, 0, size))), c))
    read = f.derive(f.fit(code, K.MAX_COLS, K.MAX_OPS))
    return [(K.KEY_INT, read.arg, 0, G)]


def _split(spec, f: _Fitter, preds, launches, nodes, **kw) -> Split:
    stored = {s for ln in launches for s in ln.slots}
    return Split(list(spec.col_kinds), list(spec.col_offsets),
                 f.prepare(preds, stored), launches, getattr(spec, "G", 1),
                 list(getattr(spec, "aggs", ())), f.kinds, f.offs,
                 [None if n is None else n.postfix() for n in nodes], **kw)


def plan_scan(spec: K.ScanSpec, all_masks: bool = False):
    """`spec` itself where one `agg_scan` launch takes it, else its
    `Split`; with all_masks, one whose mask passes take every predicate
    (the build side of a RIGHT/FULL join, whose unmatched pass needs the
    row mask whole)."""
    progs = [a.ops for a in spec.aggs if a.ops]
    if _fits(spec.col_kinds, spec.keys, spec.preds, progs, len(spec.aggs)):
        return spec
    f = _Fitter(spec.col_kinds, spec.col_offsets)
    keys = _fold_keys(f, spec.keys, spec.G)
    key_cols = frozenset(k[1] for k in keys)
    nodes = _fit_items(f, [a.ops if a.ops else None for a in spec.aggs],
                       key_cols)
    items = [(frozenset((a.pslot,)) if n is None else n.cols,
              0 if n is None else n.n_ops)
             for a, n in zip(spec.aggs, nodes)]
    bins = _pack(items, key_cols, K.MAX_AGGS)
    rest = _split_preds(f, spec.preds, bins, keep=not all_masks)
    force = spec.force_global or (
        spec.G > 1 and K.small_cells_bytes(spec) > K.SMALL_SMEM_BYTES)
    launches = []
    for b in bins:
        slots = sorted(b.cols)
        loc, kinds, offs = f.local(slots)
        aggs = []
        for i in b.items:
            a, n = spec.aggs[i], nodes[i]
            aggs.append(replace(a, ops=None if n is None else n.postfix(loc),
                                pslot=loc.get(a.pslot, 0)
                                if a.kind == K.AGG_PRESENCE else a.pslot))
        sub = K.ScanSpec(kinds, offs, [c.postfix(loc) for c in b.preds],
                         [(k, loc[s], lo, size)
                          for k, s, lo, size in keys],
                         spec.factorized, spec.G, aggs, force)
        launches.append(Launch(slots, sub, tuple(b.items)))
    return _split(spec, f, rest, launches, nodes)


def plan_probe(spec: J.ProbeSpec, right=None):
    """`spec` itself where one `join_probe` call takes it, else its
    `Split` (the build partials of its entries are set at run time).
    right: for RIGHT/FULL, (the unmatched pass's UnmatchedSpec, the build
    side's plan, {probe entry: build aggregate}): an entry's unmatched
    program is its build aggregate's, as the build plan fitted it."""
    progs = [a.ops for a in spec.aggs if a.ops]
    build = right[1] if right is not None else None
    b_split = isinstance(build, Split)
    if _fits(spec.col_kinds, spec.keys, spec.preds, progs,
             len(spec.aggs)) and not b_split:
        return spec
    f = _Fitter(spec.col_kinds, spec.col_offsets)
    keys = _fold_keys(f, spec.keys, spec.G)
    key_cols = frozenset(k[1] for k in keys)
    nodes = _fit_items(f, [a.ops if a.ops else None for a in spec.aggs],
                       key_cols)
    ub, upreds = {}, []
    if right is not None:
        uspec, _b, build_of = right
        for pi, bi in build_of.items():
            ub[pi] = parse(build.progs[bi] if b_split else
                           build.aggs[bi].ops)
        if not b_split:                # its mask passes took them all
            upreds = [parse(p) for p in uspec.preds]
    none = (frozenset(), 0)
    items = [(n.cols, n.n_ops) if n is not None else none for n in nodes]
    items = [it + ((ub[i].cols, ub[i].n_ops) if i in ub else none)
             for i, it in enumerate(items)]
    bins = _pack(items, key_cols, K.MAX_AGGS,
                 frozenset().union(*(n.cols for n in upreds)),
                 sum(n.n_ops for n in upreds))
    rest = _split_preds(f, spec.preds, bins)
    bkinds = build.slot_kinds if b_split else build and build.col_kinds
    boffs = build.slot_offsets if b_split else build and build.col_offsets
    launches = []
    for b in bins:
        slots = sorted(b.cols)
        loc, kinds, offs = f.local(slots)
        bslots = sorted(b.bcols) if right is not None else None
        bloc = {s: i for i, s in enumerate(bslots or ())}
        aggs = []
        for i in b.items:
            a, n = spec.aggs[i], nodes[i]
            if n is not None:
                a = replace(a, ops=n.postfix(loc))
            if i in ub:
                a = replace(a, ub_ops=ub[i].postfix(bloc))
            aggs.append(a)
        sub = J.ProbeSpec(kinds, offs, spec.G, spec.g, spec.outer_left,
                          [c.postfix(loc) for c in b.preds],
                          [(k, loc[s], lo, size)
                           for k, s, lo, size in keys], aggs)
        usub = None if right is None else J.UnmatchedSpec(
            [bkinds[s] for s in bslots], [boffs[s] for s in bslots],
            right[0].null_gc, [n.postfix(bloc) for n in upreds])
        launches.append(Launch(slots, sub, tuple(b.items), bslots, usub))
    return _split(spec, f, rest, launches, nodes, build=build)


def plan_topn(spec: TK.TopnSpec):
    """`spec` itself where one `topn_scan` launch takes it, else its
    `Split`."""
    if _fits(spec.col_kinds, (), spec.preds, [], 0):
        return spec
    f = _Fitter(spec.col_kinds, spec.col_offsets)
    bins = [_Bin({spec.key_slot})]
    rest = _split_preds(f, spec.preds, bins)
    slots = sorted(bins[0].cols)
    loc, kinds, offs = f.local(slots)
    sub = TK.TopnSpec(kinds, offs, loc[spec.key_slot], spec.desc,
                      spec.is_float, [c.postfix(loc) for c in bins[0].preds])
    return _split(spec, f, rest, [Launch(slots, sub, ())], [])


# -- the runners: the one launch, or the split's launches --------------------

def _prepare(split: Split, cols, rowmask, start: int, end: int):
    """Tiles [start, end) of the base columns, then the derived tiles
    after them (None where no launch reads one), and the row mask
    narrowed by the mask passes: one scan_eval launch (more only past
    MAX_INPUTS slots)."""
    tiles = [(d[start:end], m[start:end]) for d, m in cols]
    rm = rowmask[start:end]
    for slots, ev in split.prep:
        derived, rm = S.scan_eval(ev, [tiles[s] for s in slots], rm)
        tiles += derived
    return tiles, rm


def agg_scan(spec, cols, rowmask, codes, tile_start: int, tile_end: int):
    """`agg_kernels.agg_scan` over tiles [tile_start, tile_end), for a
    spec or its Split: the same (rowcount, per-aggregate outputs)."""
    if not isinstance(spec, Split):
        return K.agg_scan(spec, cols, rowmask, codes, tile_start, tile_end)
    tiles, rm = _prepare(spec, cols, rowmask, tile_start, tile_end)
    cd = None if codes is None else codes[tile_start:tile_end]
    rowcount, outs = None, [None] * len(spec.aggs)
    for ln in spec.launches:
        rc, o = K.agg_scan(ln.spec, [tiles[s] for s in ln.slots], rm, cd, 0,
                           tile_end - tile_start)
        rowcount = rc if rowcount is None else rowcount
        for p, x in zip(ln.positions, o):
            outs[p] = x
    return rowcount, outs


def join_probe(spec, cols, rowmask, codes, cnt_code, right=None):
    """`join_kernels.join_probe` for a spec or its Split: the same
    (rowcount, per-entry outputs). For RIGHT/FULL, `right` holds the
    build side's base tiles; a launch's unmatched pass reads its build
    slots of them, after the build plan's derived tiles and mask
    passes."""
    if not isinstance(spec, Split):
        return J.join_probe(spec, cols, rowmask, codes, cnt_code, right)
    tiles, rm = _prepare(spec, cols, rowmask, 0, rowmask.shape[0])
    if right is not None:
        _u, bcols, brow, bcodes = right
        btiles, brm = _prepare(spec.build, bcols, brow, 0, brow.shape[0]) \
            if isinstance(spec.build, Split) else (list(bcols), brow)
    rowcount, outs = None, [None] * len(spec.aggs)
    for ln in spec.launches:
        sub = replace(ln.spec, aggs=[replace(a, src=spec.aggs[p].src)
                                     for a, p in zip(ln.spec.aggs,
                                                     ln.positions)])
        r = None if right is None else \
            (ln.uspec, [btiles[s] for s in ln.bslots], brm, bcodes)
        rc, o = J.join_probe(sub, [tiles[s] for s in ln.slots], rm, codes,
                             cnt_code, r)
        rowcount = rc if rowcount is None else rowcount
        for p, x in zip(ln.positions, o):
            outs[p] = x
    return rowcount, outs


def topn_scan(spec, cols, rowmask, k: int):
    """`topn_kernels.topn_scan` for a spec or its Split."""
    if not isinstance(spec, Split):
        return TK.topn_scan(spec, cols, rowmask, k)
    tiles, rm = _prepare(spec, cols, rowmask, 0, rowmask.shape[0])
    ln, = spec.launches
    return TK.topn_scan(ln.spec, [tiles[s] for s in ln.slots], rm, k)
