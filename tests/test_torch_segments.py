"""tests/test_segments.py against the port, on the CPU (see tests/torch_port.py)."""

from tests.torch_port import exported, port_module

#: a build or refresh called outside any statement builds on the CPU
SUBS = ((r'(?<![\w.])(build_index_for_table|refresh_index)\(',
         r'_on_cpu(\1)('),)

globals().update(exported(port_module("test_segments", SUBS)))
