"""Data generators for the card smoke script and the tests."""
