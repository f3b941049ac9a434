"""tests/test_rbac.py against the port, on the CPU (see tests/torch_port.py)."""

from tests.torch_port import exported, port_module

globals().update(exported(port_module("test_rbac")))
