"""torch_ops_device_ms.enhance (ms; layer: models and nn; moves
enhance_au_s_per_s; the enhance cells): device ms a call in operations
that are not the port's own kernels: cuDNN, cuBLAS, elementwise,
copies."""

from port_bench.harness import is_port_kernel


def read(record):
    return record.device_ms_per_call(lambda name: not is_port_kernel(name))
