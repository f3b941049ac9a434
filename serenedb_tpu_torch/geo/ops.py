"""Copied from serenedb_tpu/geo/ops.py.

Geometry predicates and measures.

Reference analog: libs/geo/ shape predicates over S2. Design choice:
topological predicates (contains/intersects) run planar in lon/lat
degrees — correct for the region-scale shapes the reference's tests use
and orders simpler than S2; metric measures (distance, length, area) are
spherical on the mean-Earth radius, matching the reference's *_sphere
semantics and the existing point functions.
"""

from __future__ import annotations

import math

from .shapes import Geometry

EARTH_RADIUS_M = 6371008.8


# -- planar primitives -----------------------------------------------------

def _point_in_ring(p: tuple, ring: list) -> bool:
    """Ray casting; boundary counts as inside."""
    x, y = p
    n = len(ring)
    if n == 0:
        return False
    inside = False
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        if _on_segment(p, (x1, y1), (x2, y2)):
            return True
        if (y1 > y) != (y2 > y):
            xi = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
            if xi > x:
                inside = not inside
    return inside


def _on_segment(p, a, b, eps=1e-12) -> bool:
    (px, py), (ax, ay), (bx, by) = p, a, b
    cross = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    if abs(cross) > eps * max(1.0, abs(bx - ax) + abs(by - ay)):
        return False
    return (min(ax, bx) - eps <= px <= max(ax, bx) + eps and
            min(ay, by) - eps <= py <= max(ay, by) + eps)


def _point_in_polygon(p: tuple, rings: list) -> bool:
    if not rings or not _point_in_ring(p, rings[0]):
        return False
    for hole in rings[1:]:
        # strictly inside a hole = outside (hole boundary still counts in)
        if _point_in_ring(p, hole) and not any(
                _on_segment(p, hole[i], hole[(i + 1) % len(hole)])
                for i in range(len(hole))):
            return False
    return True


def _segs_intersect(s1, s2) -> bool:
    (a, b), (c, d) = s1, s2

    def orient(p, q, r):
        v = (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0])
        if abs(v) < 1e-18:
            return 0
        return 1 if v > 0 else -1
    o1, o2 = orient(a, b, c), orient(a, b, d)
    o3, o4 = orient(c, d, a), orient(c, d, b)
    if o1 != o2 and o3 != o4:
        return True
    return (_on_segment(c, a, b) or _on_segment(d, a, b) or
            _on_segment(a, c, d) or _on_segment(b, c, d))


# -- predicates ------------------------------------------------------------

def intersects(g1: Geometry, g2: Geometry) -> bool:
    # point fast paths
    if g1.kind == "point":
        return _point_touches(g1.coords, g2)
    if g2.kind == "point":
        return _point_touches(g2.coords, g1)
    # any vertex of one inside a polygon of the other
    for poly in g2.polygons():
        if any(_point_in_polygon(p, poly) for p in g1.points()):
            return True
    for poly in g1.polygons():
        if any(_point_in_polygon(p, poly) for p in g2.points()):
            return True
    # segment crossings
    s2 = g2.segments()
    return any(_segs_intersect(a, b) for a in g1.segments() for b in s2)


def _point_touches(p: tuple, g: Geometry) -> bool:
    k = g.kind
    if k == "point":
        return abs(p[0] - g.coords[0]) < 1e-12 and \
            abs(p[1] - g.coords[1]) < 1e-12
    if k == "multipoint":
        return any(abs(p[0] - q[0]) < 1e-12 and abs(p[1] - q[1]) < 1e-12
                   for q in g.coords)
    if k in ("linestring", "multilinestring"):
        return any(_on_segment(p, a, b) for a, b in g.segments())
    if k in ("polygon", "multipolygon"):
        return any(_point_in_polygon(p, poly) for poly in g.polygons())
    if k == "geometrycollection":
        return any(_point_touches(p, x) for x in g.coords)
    return False


def contains(g1: Geometry, g2: Geometry) -> bool:
    """g1 contains g2 (boundary-inclusive, like ST_Covers)."""
    if g1.kind in ("polygon", "multipolygon"):
        polys = g1.polygons()
        pts = g2.points()
        if not pts:
            return False
        if not all(any(_point_in_polygon(p, poly) for poly in polys)
                   for p in pts):
            return False
        # vertices inside is not sufficient for shapes with holes or
        # concavities: no g2 edge may cross a ring boundary
        ring_segs = [s for poly in polys
                     for ring in poly
                     for s in zip(ring, ring[1:] + ring[:1])]
        for seg in g2.segments():
            mid = ((seg[0][0] + seg[1][0]) / 2.0,
                   (seg[0][1] + seg[1][1]) / 2.0)
            if not any(_point_in_polygon(mid, poly) for poly in polys):
                return False
            for rs in ring_segs:
                if _segs_intersect(seg, rs) and not (
                        _on_segment(seg[0], *rs) or
                        _on_segment(seg[1], *rs)):
                    return False
        return True
    if g1.kind == "point":
        return g2.kind == "point" and _point_touches(g2.coords, g1)
    if g1.kind in ("linestring", "multilinestring"):
        return all(_point_touches(p, g1) for p in g2.points()) and \
            g2.kind in ("point", "multipoint", "linestring",
                        "multilinestring")
    if g1.kind == "multipoint":
        return g2.kind in ("point", "multipoint") and \
            all(_point_touches(p, g1) for p in g2.points())
    if g1.kind == "geometrycollection":
        return any(contains(x, g2) for x in g1.coords)
    return False


# -- measures --------------------------------------------------------------

def haversine_m(p1: tuple, p2: tuple) -> float:
    lat1, lat2 = math.radians(p1[1]), math.radians(p2[1])
    dlat = lat2 - lat1
    dlon = math.radians(p2[0] - p1[0])
    a = math.sin(dlat / 2) ** 2 + \
        math.cos(lat1) * math.cos(lat2) * math.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * math.asin(min(math.sqrt(a), 1.0))


def _point_seg_distance_m(p: tuple, a: tuple, b: tuple) -> float:
    """Great-circle point→segment distance via local equirectangular
    projection around the point (meter-accurate at region scale)."""
    lat0 = math.radians(p[1])
    kx = math.cos(lat0) * EARTH_RADIUS_M * math.pi / 180.0
    ky = EARTH_RADIUS_M * math.pi / 180.0

    def proj(q):
        return ((q[0] - p[0]) * kx, (q[1] - p[1]) * ky)
    ax, ay = proj(a)
    bx, by = proj(b)
    dx, dy = bx - ax, by - ay
    denom = dx * dx + dy * dy
    t = 0.0 if denom == 0 else max(
        0.0, min(1.0, -(ax * dx + ay * dy) / denom))
    cx, cy = ax + t * dx, ay + t * dy
    return math.hypot(cx, cy)


def distance_m(g1: Geometry, g2: Geometry) -> float:
    if intersects(g1, g2):
        return 0.0
    best = math.inf
    p1, p2 = g1.points(), g2.points()
    s1, s2 = g1.segments(), g2.segments()
    for p in p1:
        for q in p2:
            best = min(best, haversine_m(p, q))
        for a, b in s2:
            best = min(best, _point_seg_distance_m(p, a, b))
    for q in p2:
        for a, b in s1:
            best = min(best, _point_seg_distance_m(q, a, b))
    return best if best is not math.inf else 0.0


def length_m(g: Geometry) -> float:
    if g.kind in ("linestring", "multilinestring"):
        return sum(haversine_m(a, b) for a, b in g.segments())
    if g.kind == "geometrycollection":
        return sum(length_m(x) for x in g.coords)
    return 0.0


def perimeter_m(g: Geometry) -> float:
    if g.kind in ("polygon", "multipolygon"):
        return sum(haversine_m(a, b) for a, b in g.segments())
    if g.kind == "geometrycollection":
        return sum(perimeter_m(x) for x in g.coords)
    return 0.0


def _ring_area_sphere(ring: list) -> float:
    """Spherical polygon area via the spherical shoelace sum
    Σ (λ2−λ1)·(2 + sin φ1 + sin φ2) / 2 · R² — exact on great-circle
    edges at the small-edge limit."""
    if len(ring) < 3:
        return 0.0
    total = 0.0
    closed = list(ring)
    if closed[0] != closed[-1]:
        closed.append(closed[0])
    for i in range(len(closed) - 1):
        lon1, lat1 = map(math.radians, closed[i])
        lon2, lat2 = map(math.radians, closed[i + 1])
        total += (lon2 - lon1) * (2 + math.sin(lat1) + math.sin(lat2))
    return abs(total) / 2.0 * EARTH_RADIUS_M ** 2


def area_m2(g: Geometry) -> float:
    total = 0.0
    for poly in g.polygons():
        if poly:
            total += _ring_area_sphere(poly[0])
            for hole in poly[1:]:
                total -= _ring_area_sphere(hole)
    return max(total, 0.0)


def centroid(g: Geometry) -> tuple:
    """Vertex centroid for points/lines; area-weighted planar centroid
    for polygons (matches the ES/PG expectation at region scale)."""
    polys = g.polygons()
    if polys:
        ax = ay = aw = 0.0
        for poly in polys:
            ring = poly[0]
            closed = list(ring)
            if closed[0] != closed[-1]:
                closed.append(closed[0])
            a = cx = cy = 0.0
            for i in range(len(closed) - 1):
                x1, y1 = closed[i]
                x2, y2 = closed[i + 1]
                cross = x1 * y2 - x2 * y1
                a += cross
                cx += (x1 + x2) * cross
                cy += (y1 + y2) * cross
            if abs(a) > 1e-18:
                ax += cx / (3 * a) * abs(a)
                ay += cy / (3 * a) * abs(a)
                aw += abs(a)
        if aw > 0:
            return (ax / aw, ay / aw)
    pts = g.points()
    if not pts:
        return (0.0, 0.0)
    return (sum(p[0] for p in pts) / len(pts),
            sum(p[1] for p in pts) / len(pts))


def envelope(g: Geometry) -> Geometry:
    pts = g.points()
    if not pts:
        return Geometry("polygon", [])
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x1, x2, y1, y2 = min(xs), max(xs), min(ys), max(ys)
    return Geometry("polygon", [[(x1, y1), (x2, y1), (x2, y2), (x1, y2),
                                 (x1, y1)]])


def bbox_contains(top: float, left: float, bottom: float, right: float,
                  p: tuple) -> bool:
    """geo_bounding_box semantics (ES): top-left / bottom-right corners."""
    return left <= p[0] <= right and bottom <= p[1] <= top
