"""Plain references, one module per configuration. They import numpy and
the standard library only: nothing of the program under test."""
