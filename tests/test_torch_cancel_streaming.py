"""tests/test_cancel_streaming.py against the port, on the CPU (see tests/torch_port.py)."""

from tests.torch_port import exported, port_module

#: the reference's loose 'device' value is the port's 'gpu'
SUBS = (("'device'", "'gpu'"),)

globals().update(exported(port_module("test_cancel_streaming", SUBS)))
