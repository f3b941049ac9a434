"""Scalar SQL functions (copied from serenedb_tpu/functions)."""
