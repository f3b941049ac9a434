"""Copied from serenedb_tpu/geo/cells.py.

Hierarchical grid cells for geo indexing (S2-cell-term analog).

Reference analog: server/connector/geo_filter_builder.cpp + the
iresearch GeoFilter — geometries are indexed as cell terms so geo
predicates become inverted-index candidate lookups with exact
post-verification, instead of per-row shape math over the whole table.

Scheme: equirectangular quadtree over (lon, lat). A level-L cell is one
tile of the 2^L x 2^L grid. Every geometry indexes its bbox covering at
the finest level of LEVELS whose covering stays within COVER_CAP cells,
PLUS the ancestors of those cells at every coarser level of LEVELS.
Queries expand the same way, so two intersecting shapes always share at
least one term: at the coarser of their two covering levels both emit
the cell containing any common point.

Cell ids pack (level, x, y) into one int: level << 56 | x << 28 | y.
"""

from __future__ import annotations

import math

#: covering levels, coarse → fine. Level L tiles are 360/2^L degrees
#: wide: ~22°, 1.4°, 5.3' (~9.8km), 20" (~600m), 1.2" (~38m). Level
#: selection is adaptive per geometry extent (_chosen_level picks the
#: finest level whose covering stays within COVER_CAP — the S2
#: RegionCoverer analog, reference: server/connector/
#: geo_filter_builder.cpp), so point-ish data lands on ~38m tiles while
#: continental polygons stay coarse. Extending this tuple is
#: backward-compatible with already-indexed terms: queries probe every
#: coarser level, a superset of any older scheme's levels.
LEVELS = (4, 8, 12, 16, 20)
COVER_CAP = 64          # max cells per covering at the chosen level


def _cell_id(level: int, x: int, y: int) -> int:
    return (level << 56) | (x << 28) | y


def _bbox(geom) -> tuple:
    """(min_lon, min_lat, max_lon, max_lat)."""
    pts = [p for p in geom.points()]
    for poly in geom.polygons():
        for ring in poly:
            pts.extend(ring)
    for seg in geom.segments():
        pts.extend(seg)
    if not pts:
        raise ValueError("empty geometry")
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    return (min(xs), min(ys), max(xs), max(ys))


def _clamp(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def _cell_range(bbox, level):
    """Inclusive (x0, x1, y0, y1) tile range covering the bbox."""
    n = 1 << level
    min_lon, min_lat, max_lon, max_lat = bbox
    x0 = int(_clamp((min_lon + 180.0) / 360.0, 0, 1 - 1e-12) * n)
    x1 = int(_clamp((max_lon + 180.0) / 360.0, 0, 1 - 1e-12) * n)
    y0 = int(_clamp((min_lat + 90.0) / 180.0, 0, 1 - 1e-12) * n)
    y1 = int(_clamp((max_lat + 90.0) / 180.0, 0, 1 - 1e-12) * n)
    return x0, x1, y0, y1


#: ancestor-space bit: terms emitted for a cell's COARSER parents live in
#: a separate term space so a fine query probing its own level never
#: pulls every finely-indexed row of a huge coarse tile
_ANC = 1 << 62


def _chosen_level(bbox) -> int:
    chosen = LEVELS[0]
    for lv in reversed(LEVELS):
        x0, x1, y0, y1 = _cell_range(bbox, lv)
        if (x1 - x0 + 1) * (y1 - y0 + 1) <= COVER_CAP:
            chosen = lv
            break
    return chosen


def _covering(bbox, level) -> list:
    x0, x1, y0, y1 = _cell_range(bbox, level)
    return [(x, y) for x in range(x0, x1 + 1) for y in range(y0, y1 + 1)]


def geometry_terms(geom) -> list:
    """Index terms for a geometry: covering cells at its chosen level
    (covering space) + those cells' ancestors at every coarser level of
    LEVELS (ancestor space). Matching invariant with query_terms: two
    intersecting shapes share a term at the coarser of their covering
    levels — as covering/covering, covering/ancestor, or
    ancestor/covering depending on which side is finer."""
    return _box_index_terms(_bbox(geom))


def expand_bbox_multi(bbox, radius_m: float) -> list:
    """Conservatively grow a bbox by a metre radius (for ST_DWithin):
    latitude pads by radius/111km; longitude by the same over cos(lat),
    degrading to the full circle near the poles. Longitude WRAPS at the
    antimeridian — the expansion may return TWO boxes (the exact
    haversine predicate is periodic; clamping would silently drop
    matches across +/-180)."""
    min_lon, min_lat, max_lon, max_lat = bbox
    dlat = radius_m / 111_000.0
    lat_lo = max(-90.0, min_lat - dlat)
    lat_hi = min(90.0, max_lat + dlat)
    # a circle that reaches a pole spans EVERY longitude (haversine is
    # periodic over the pole); and near the poles cos() shrinks the
    # metres-per-degree so fast that any clamped dlon understates the
    # true extent — widen to the full circle in both cases
    if lat_hi >= 90.0 - 1e-9 or lat_lo <= -90.0 + 1e-9:
        return [(-180.0, lat_lo, 180.0, lat_hi)]
    max_abs_lat = max(abs(lat_lo), abs(lat_hi))
    cosv = math.cos(math.radians(max_abs_lat))
    dlon = radius_m / (111_000.0 * cosv) if cosv > 1e-9 else 361.0
    lo = min_lon - dlon
    hi = max_lon + dlon
    if hi - lo >= 360.0 or dlon >= 180.0:
        return [(-180.0, lat_lo, 180.0, lat_hi)]
    if lo < -180.0:
        return [(lo + 360.0, lat_lo, 180.0, lat_hi),
                (-180.0, lat_lo, hi, lat_hi)]
    if hi > 180.0:
        return [(lo, lat_lo, 180.0, lat_hi),
                (-180.0, lat_lo, hi - 360.0, lat_hi)]
    return [(lo, lat_lo, hi, lat_hi)]


def point_terms(lon: float, lat: float) -> list:
    """Index terms for a single point — the degenerate-bbox case of
    geometry_terms, shared so the index build fast path can never
    diverge from the term scheme."""
    return _box_index_terms((lon, lat, lon, lat))


def _box_index_terms(box) -> list:
    chosen = _chosen_level(box)
    terms = set()
    for x, y in _covering(box, chosen):
        terms.add(_cell_id(chosen, x, y))
    for lv in LEVELS:
        if lv >= chosen:
            break
        for x, y in _covering(box, lv):
            terms.add(_ANC | _cell_id(lv, x, y))
    return sorted(terms)


def query_terms(geom, radius_m: float = 0.0) -> list:
    """Terms to PROBE for a query geometry (optionally dwithin-expanded):
    per covering cell q at the query's level — covering-space q (equal
    level matches), ancestor-space q (finer-indexed shapes below q), and
    covering-space ancestors of q (coarser-indexed shapes above q)."""
    box = _bbox(geom)
    boxes = expand_bbox_multi(box, radius_m) if radius_m > 0 else [box]
    terms = set()
    for b in boxes:
        chosen = _chosen_level(b)
        for x, y in _covering(b, chosen):
            terms.add(_cell_id(chosen, x, y))
            terms.add(_ANC | _cell_id(chosen, x, y))
        for lv in LEVELS:
            if lv >= chosen:
                break
            for x, y in _covering(b, lv):
                terms.add(_cell_id(lv, x, y))
    return sorted(terms)
