"""Copied from serenedb_tpu/geo/__init__.py.

Geo shapes: WKT/WKB/GeoJSON codecs + spherical/planar geometry ops.

Reference analog: libs/geo/ (S2-backed shape_container, wkb.cpp,
geo_json.cpp). TPU re-design: geometries stay host-side text/bytes (geo
predicates are catalog-cardinality filter work, not MXU work); the batch
seam is the ST_* function layer, which evaluates whole columns per call.
"""

from .shapes import (Geometry, from_geojson, from_wkb, from_wkt,
                     to_geojson, to_wkb, to_wkt)

__all__ = ["Geometry", "from_wkt", "to_wkt", "from_wkb", "to_wkb",
           "from_geojson", "to_geojson"]
