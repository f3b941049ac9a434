"""Copied from serenedb_tpu/geo/shapes.py.

Geometry model + WKT / WKB / GeoJSON codecs.

Reference analog: libs/geo/shape_container.{h,cpp} (tagged S2 geometry
union), libs/geo/wkb.cpp (byte-order-aware WKB), libs/geo/geo_json.cpp.
Coordinates are (lon, lat) pairs in degrees, like the reference's
GeoJSON/WKB surface.
"""

from __future__ import annotations

import json
import re
import struct
from dataclasses import dataclass
from typing import Iterable

from .. import errors


def _err(msg: str) -> errors.SqlError:
    return errors.SqlError(errors.INVALID_TEXT_REPRESENTATION, msg)


# kind ∈ point linestring polygon multipoint multilinestring multipolygon
# geometrycollection
@dataclass
class Geometry:
    kind: str
    # point: (x, y); linestring/multipoint: [(x,y)..]; polygon/
    # multilinestring: [[(x,y)..]..]; multipolygon: [[[..]..]..];
    # geometrycollection: [Geometry..]
    coords: object

    def polygons(self) -> list[list[list[tuple]]]:
        """All polygons (as ring lists) in this geometry."""
        if self.kind == "polygon":
            return [self.coords]
        if self.kind == "multipolygon":
            return list(self.coords)
        if self.kind == "geometrycollection":
            out = []
            for g in self.coords:
                out.extend(g.polygons())
            return out
        return []

    def points(self) -> list[tuple]:
        """Every vertex in the geometry."""
        k = self.kind
        if k == "point":
            return [self.coords]
        if k in ("linestring", "multipoint"):
            return list(self.coords)
        if k in ("polygon", "multilinestring"):
            return [p for ring in self.coords for p in ring]
        if k == "multipolygon":
            return [p for poly in self.coords for ring in poly
                    for p in ring]
        if k == "geometrycollection":
            return [p for g in self.coords for p in g.points()]
        return []

    def segments(self) -> list[tuple]:
        """Every line segment ((x1,y1),(x2,y2)); polygon rings closed."""
        k = self.kind
        if k == "linestring":
            return list(zip(self.coords, self.coords[1:]))
        if k == "multilinestring":
            return [s for ls in self.coords
                    for s in zip(ls, ls[1:])]
        if k in ("polygon", "multipolygon"):
            out = []
            for ring in ([r for r in self.coords] if k == "polygon"
                         else [r for poly in self.coords for r in poly]):
                closed = list(ring)
                if closed and closed[0] != closed[-1]:
                    closed.append(closed[0])
                out.extend(zip(closed, closed[1:]))
            return out
        if k == "geometrycollection":
            return [s for g in self.coords for g_s in [g.segments()]
                    for s in g_s]
        return []


# -- WKT -------------------------------------------------------------------

_WKT_KINDS = ("geometrycollection", "multipolygon", "multilinestring",
              "multipoint", "polygon", "linestring", "point")


def _parse_coord_pair(tok: str) -> tuple:
    parts = tok.split()
    if len(parts) < 2:
        raise _err(f"invalid coordinate {tok!r}")
    try:
        return (float(parts[0]), float(parts[1]))
    except ValueError:
        raise _err(f"invalid coordinate {tok!r}")


def _split_top(s: str) -> list[str]:
    """Split on commas at paren depth 0."""
    out, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(s[start:i])
            start = i + 1
    out.append(s[start:])
    return [p.strip() for p in out]


def _strip_parens(s: str) -> str:
    s = s.strip()
    if not (s.startswith("(") and s.endswith(")")):
        raise _err(f"expected parenthesized list near {s[:30]!r}")
    return s[1:-1].strip()


def _parse_ring_list(s: str) -> list[list[tuple]]:
    return [[_parse_coord_pair(c) for c in _split_top(_strip_parens(ring))]
            for ring in _split_top(s)]


def from_wkt(text: str) -> Geometry:
    s = text.strip()
    low = s.lower()
    for kind in _WKT_KINDS:
        if low.startswith(kind):
            rest = s[len(kind):].strip()
            break
    else:
        raise _err(f"unrecognized geometry {text[:40]!r}")
    if rest.lower() == "empty":
        return Geometry(kind, () if kind == "point" else [])
    body = _strip_parens(rest)
    if kind == "point":
        return Geometry("point", _parse_coord_pair(body))
    if kind == "linestring":
        return Geometry("linestring",
                        [_parse_coord_pair(c) for c in _split_top(body)])
    if kind == "multipoint":
        # both MULTIPOINT(1 2, 3 4) and MULTIPOINT((1 2), (3 4))
        pts = []
        for tok in _split_top(body):
            tok = tok.strip()
            if tok.startswith("("):
                tok = _strip_parens(tok)
            pts.append(_parse_coord_pair(tok))
        return Geometry("multipoint", pts)
    if kind == "polygon":
        return Geometry("polygon", _parse_ring_list(body))
    if kind == "multilinestring":
        return Geometry("multilinestring", _parse_ring_list(body))
    if kind == "multipolygon":
        return Geometry("multipolygon",
                        [_parse_ring_list(_strip_parens(p))
                         for p in _split_top(body)])
    # geometrycollection
    return Geometry("geometrycollection",
                    [from_wkt(g) for g in _split_top(body)])


def _fmt(v: float) -> str:
    return repr(float(v))


def _fmt_pair(p) -> str:
    return f"{_fmt(p[0])} {_fmt(p[1])}"


def to_wkt(g: Geometry) -> str:
    k = g.kind
    name = k.upper()
    if not g.coords and k != "point" or (k == "point" and g.coords == ()):
        return f"{name} EMPTY"
    if k == "point":
        return f"POINT({_fmt_pair(g.coords)})"
    if k in ("linestring", "multipoint"):
        return f"{name}({', '.join(_fmt_pair(p) for p in g.coords)})"
    if k in ("polygon", "multilinestring"):
        rings = ", ".join(
            "(" + ", ".join(_fmt_pair(p) for p in ring) + ")"
            for ring in g.coords)
        return f"{name}({rings})"
    if k == "multipolygon":
        polys = ", ".join(
            "(" + ", ".join(
                "(" + ", ".join(_fmt_pair(p) for p in ring) + ")"
                for ring in poly) + ")"
            for poly in g.coords)
        return f"MULTIPOLYGON({polys})"
    return ("GEOMETRYCOLLECTION(" +
            ", ".join(to_wkt(x) for x in g.coords) + ")")


# -- WKB -------------------------------------------------------------------

_WKB_CODE = {"point": 1, "linestring": 2, "polygon": 3, "multipoint": 4,
             "multilinestring": 5, "multipolygon": 6,
             "geometrycollection": 7}
_WKB_KIND = {v: k for k, v in _WKB_CODE.items()}


def to_wkb(g: Geometry) -> bytes:
    """Little-endian WKB."""
    out = bytearray()
    _wkb_emit(g, out)
    return bytes(out)


def _wkb_emit(g: Geometry, out: bytearray) -> None:
    out += b"\x01" + struct.pack("<I", _WKB_CODE[g.kind])
    k = g.kind
    if k == "point":
        x, y = (g.coords if g.coords else (float("nan"), float("nan")))
        out += struct.pack("<dd", x, y)
    elif k == "linestring":
        out += struct.pack("<I", len(g.coords))
        for x, y in g.coords:
            out += struct.pack("<dd", x, y)
    elif k == "polygon":
        out += struct.pack("<I", len(g.coords))
        for ring in g.coords:
            out += struct.pack("<I", len(ring))
            for x, y in ring:
                out += struct.pack("<dd", x, y)
    elif k in ("multipoint", "multilinestring", "multipolygon",
               "geometrycollection"):
        inner_kind = {"multipoint": "point",
                      "multilinestring": "linestring",
                      "multipolygon": "polygon"}.get(k)
        items = (g.coords if k == "geometrycollection"
                 else [Geometry(inner_kind, c) for c in g.coords])
        out += struct.pack("<I", len(items))
        for item in items:
            _wkb_emit(item, out)


def from_wkb(data: bytes) -> Geometry:
    g, off = _wkb_parse(data, 0)
    return g


def _wkb_parse(data: bytes, off: int) -> tuple[Geometry, int]:
    try:
        bo = "<" if data[off] == 1 else ">"
        (code,) = struct.unpack_from(bo + "I", data, off + 1)
        off += 5
        if code & 0x20000000:          # EWKB SRID flag: skip the srid
            code &= ~0x20000000
            off += 4
        code &= 0xFF
        kind = _WKB_KIND.get(code)
        if kind is None:
            raise _err(f"unknown WKB geometry code {code}")
        if kind == "point":
            x, y = struct.unpack_from(bo + "dd", data, off)
            return Geometry("point", (x, y)), off + 16
        if kind == "linestring":
            (n,) = struct.unpack_from(bo + "I", data, off)
            off += 4
            pts = [struct.unpack_from(bo + "dd", data, off + 16 * i)
                   for i in range(n)]
            return Geometry("linestring", [tuple(p) for p in pts]), \
                off + 16 * n
        if kind == "polygon":
            (nr,) = struct.unpack_from(bo + "I", data, off)
            off += 4
            rings = []
            for _ in range(nr):
                (n,) = struct.unpack_from(bo + "I", data, off)
                off += 4
                ring = [tuple(struct.unpack_from(bo + "dd", data,
                                                 off + 16 * i))
                        for i in range(n)]
                off += 16 * n
                rings.append(ring)
            return Geometry("polygon", rings), off
        # multi*/collection
        (n,) = struct.unpack_from(bo + "I", data, off)
        off += 4
        items = []
        for _ in range(n):
            item, off = _wkb_parse(data, off)
            items.append(item)
        if kind == "geometrycollection":
            return Geometry(kind, items), off
        return Geometry(kind, [i.coords for i in items]), off
    except (struct.error, IndexError):
        raise _err("malformed WKB geometry")


# -- GeoJSON ---------------------------------------------------------------

_GJ_NAME = {"point": "Point", "linestring": "LineString",
            "polygon": "Polygon", "multipoint": "MultiPoint",
            "multilinestring": "MultiLineString",
            "multipolygon": "MultiPolygon",
            "geometrycollection": "GeometryCollection"}
_GJ_KIND = {v.lower(): k for k, v in _GJ_NAME.items()}


def _tuples(x):
    if isinstance(x, (list, tuple)) and x and \
            isinstance(x[0], (int, float)):
        return (float(x[0]), float(x[1]))
    return [_tuples(i) for i in x]


def from_geojson(obj) -> Geometry:
    if isinstance(obj, str):
        try:
            obj = json.loads(obj)
        except json.JSONDecodeError as e:
            raise _err(f"invalid GeoJSON: {e}")
    if not isinstance(obj, dict):
        raise _err("GeoJSON geometry must be an object")
    t = str(obj.get("type", "")).lower()
    if t == "feature":
        return from_geojson(obj.get("geometry"))
    kind = _GJ_KIND.get(t)
    if kind is None:
        raise _err(f"unknown GeoJSON type {obj.get('type')!r}")
    if kind == "geometrycollection":
        return Geometry(kind, [from_geojson(g)
                               for g in obj.get("geometries", [])])
    coords = obj.get("coordinates")
    if coords is None:
        raise _err("GeoJSON geometry lacks coordinates")
    try:
        return Geometry(kind, _tuples(coords))
    except (TypeError, IndexError):
        raise _err("malformed GeoJSON coordinates")


def to_geojson(g: Geometry) -> dict:
    if g.kind == "geometrycollection":
        return {"type": "GeometryCollection",
                "geometries": [to_geojson(x) for x in g.coords]}

    def unpack(c):
        if isinstance(c, tuple):
            return [c[0], c[1]]
        return [unpack(i) for i in c]
    return {"type": _GJ_NAME[g.kind], "coordinates": unpack(g.coords)}


_LATLON_RE = re.compile(
    r"^\s*(-?\d+(?:\.\d+)?)\s*,\s*(-?\d+(?:\.\d+)?)\s*$")


def parse_any(text) -> Geometry:
    """WKT, GeoJSON, bare '[lon, lat]', ES {'lat':…,'lon':…} objects, or
    the ES 'lat,lon' string — the permissive input seam the ST_ functions
    and ES geo queries share."""
    if isinstance(text, dict):
        if "lat" in text and "lon" in text:
            return Geometry("point",
                            (float(text["lon"]), float(text["lat"])))
        return from_geojson(text)
    if isinstance(text, (list, tuple)):
        return Geometry("point", (float(text[0]), float(text[1])))
    t = str(text).strip()
    if t[:1] in "[{":
        v = json.loads(t)
        return parse_any(v)
    m = _LATLON_RE.match(t)
    if m:       # ES point string is LAT,LON order
        return Geometry("point", (float(m.group(2)), float(m.group(1))))
    return from_wkt(t)
