"""tests/test_listen.py against the port, on the CPU (see tests/torch_port.py)."""

from tests.torch_port import exported, port_module

#: the port's build id names its own package
SUBS = (('"serenedb-tpu 0\\.1\\.0"', '"serenedb-tpu-torch 0.1.0"'),)

globals().update(exported(port_module("test_listen", SUBS)))
