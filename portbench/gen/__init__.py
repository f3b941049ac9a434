"""Data generators, one module per configuration (`generate`)."""
