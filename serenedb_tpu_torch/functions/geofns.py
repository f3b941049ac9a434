"""Copied from serenedb_tpu/functions/geofns.py.

ST_* geometry SQL functions over the geo shape layer.

Reference analog: server/connector/functions/geo.cpp (S2-backed GEO_*
/ ST_* functions) + libs/geo codecs. Registered on import from scalar.py;
evaluates whole columns per call with a per-call parse memo (geometry
arguments are usually constant literals)."""

from __future__ import annotations

import json

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Column
from ..geo import ops as geo_ops
from ..geo import shapes as geo_shapes
from ..sql.expr import make_string_column, propagate_nulls, string_values
from .scalar import FunctionResolution, _REGISTRY, _result, _stringish


def _parse_cached(text: str, cache: dict) -> geo_shapes.Geometry:
    g = cache.get(text)
    if g is None:
        g = cache[text] = geo_shapes.parse_any(text)
    return g


def _geom_pair_resolver(fn, result_type=dt.BOOL, name="st_fn"):
    """(geom_text, geom_text) -> scalar via fn(Geometry, Geometry)."""
    def resolver(ts):
        if len(ts) < 2 or not all(_stringish(t) for t in ts[:2]):
            return None

        def impl(cols, n):
            a = string_values(cols[0])
            b = string_values(cols[1])
            valid = propagate_nulls(cols)
            cache: dict = {}
            if result_type is dt.BOOL:
                out = np.zeros(n, dtype=bool)
            else:
                out = np.zeros(n, dtype=np.float64)
            for i in range(n):
                if valid is not None and not valid[i]:
                    continue
                out[i] = fn(_parse_cached(a[i], cache),
                            _parse_cached(b[i], cache))
            return _result(result_type, out, cols[:2])
        return FunctionResolution(result_type, impl)
    return resolver


def _geom_unary_resolver(fn, result_type, to_text=False):
    def resolver(ts):
        if not ts or not _stringish(ts[0]):
            return None

        def impl(cols, n):
            a = string_values(cols[0])
            valid = propagate_nulls(cols)
            cache: dict = {}
            if to_text:
                out = []
                for i in range(n):
                    if valid is not None and not valid[i]:
                        out.append("")
                        continue
                    out.append(fn(_parse_cached(a[i], cache)))
                return make_string_column(
                    np.asarray(out, dtype=object).astype(str), valid)
            out = np.zeros(n, dtype=result_type.np_dtype)
            for i in range(n):
                if valid is not None and not valid[i]:
                    continue
                out[i] = fn(_parse_cached(a[i], cache))
            return _result(result_type, out, cols[:1])
        return FunctionResolution(result_type, impl)
    return resolver


# constructors / converters -------------------------------------------------

_REGISTRY["st_geomfromtext"] = _geom_unary_resolver(
    lambda g: geo_shapes.to_wkt(g), dt.VARCHAR, to_text=True)
_REGISTRY["st_geometryfromtext"] = _REGISTRY["st_geomfromtext"]
_REGISTRY["st_astext"] = _REGISTRY["st_geomfromtext"]

_REGISTRY["st_asgeojson"] = _geom_unary_resolver(
    lambda g: json.dumps(geo_shapes.to_geojson(g)), dt.VARCHAR,
    to_text=True)
_REGISTRY["st_geomfromgeojson"] = _geom_unary_resolver(
    lambda g: geo_shapes.to_wkt(g), dt.VARCHAR, to_text=True)

_REGISTRY["st_asbinary"] = _geom_unary_resolver(
    lambda g: geo_shapes.to_wkb(g).hex(), dt.VARCHAR, to_text=True)
_REGISTRY["st_aswkb"] = _REGISTRY["st_asbinary"]


def _from_wkb_resolver(ts):
    if not ts or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        a = string_values(cols[0])
        valid = propagate_nulls(cols)
        out = []
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append("")
                continue
            try:
                raw = bytes.fromhex(a[i].strip().removeprefix("\\x"))
            except ValueError:
                raise errors.SqlError(errors.INVALID_TEXT_REPRESENTATION,
                                      "invalid WKB hex")
            out.append(geo_shapes.to_wkt(geo_shapes.from_wkb(raw)))
        return make_string_column(
            np.asarray(out, dtype=object).astype(str), valid)
    return FunctionResolution(dt.VARCHAR, impl)


_REGISTRY["st_geomfromwkb"] = _from_wkb_resolver

# predicates ---------------------------------------------------------------

_REGISTRY["st_contains"] = _geom_pair_resolver(geo_ops.contains)
_REGISTRY["st_covers"] = _geom_pair_resolver(geo_ops.contains)
_REGISTRY["st_within"] = _geom_pair_resolver(
    lambda a, b: geo_ops.contains(b, a))
_REGISTRY["st_coveredby"] = _REGISTRY["st_within"]
_REGISTRY["st_intersects"] = _geom_pair_resolver(geo_ops.intersects)
_REGISTRY["st_disjoint"] = _geom_pair_resolver(
    lambda a, b: not geo_ops.intersects(a, b))


def _st_dwithin(ts):
    if len(ts) != 3 or not all(_stringish(t) for t in ts[:2]) or not (
            ts[2].is_numeric or ts[2].id is dt.TypeId.NULL):
        return None

    def impl(cols, n):
        a = string_values(cols[0])
        b = string_values(cols[1])
        dist = cols[2].data.astype(np.float64)
        valid = propagate_nulls(cols)
        cache: dict = {}
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            out[i] = geo_ops.distance_m(
                _parse_cached(a[i], cache),
                _parse_cached(b[i], cache)) <= dist[i]
        return _result(dt.BOOL, out, cols)
    return FunctionResolution(dt.BOOL, impl)


_REGISTRY["st_dwithin"] = _st_dwithin

# general-geometry distance replaces the point-only fast path (same
# spherical radius; distance_m(point, point) IS the haversine formula)
_REGISTRY["st_distance"] = _geom_pair_resolver(geo_ops.distance_m,
                                               dt.DOUBLE)
_REGISTRY["st_distance_sphere"] = _REGISTRY["st_distance"]

# measures -----------------------------------------------------------------

_REGISTRY["st_area"] = _geom_unary_resolver(geo_ops.area_m2, dt.DOUBLE)
_REGISTRY["st_length"] = _geom_unary_resolver(geo_ops.length_m, dt.DOUBLE)
_REGISTRY["st_perimeter"] = _geom_unary_resolver(geo_ops.perimeter_m,
                                                 dt.DOUBLE)
_REGISTRY["st_npoints"] = _geom_unary_resolver(
    lambda g: len(g.points()), dt.INT)
_REGISTRY["st_geometrytype"] = _geom_unary_resolver(
    lambda g: "ST_" + geo_shapes._GJ_NAME[g.kind], dt.VARCHAR,
    to_text=True)
_REGISTRY["st_centroid"] = _geom_unary_resolver(
    lambda g: geo_shapes.to_wkt(
        geo_shapes.Geometry("point", geo_ops.centroid(g))),
    dt.VARCHAR, to_text=True)
_REGISTRY["st_envelope"] = _geom_unary_resolver(
    lambda g: geo_shapes.to_wkt(geo_ops.envelope(g)), dt.VARCHAR,
    to_text=True)
