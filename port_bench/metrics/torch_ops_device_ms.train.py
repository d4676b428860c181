"""torch_ops_device_ms.train (ms; layer: models, nn and autograd; moves
train_au_s_per_s; the train cell): device ms a step in operations that
are not the port's own kernels: the twins' recomputed backward (its
GEMMs), cuDNN, elementwise, the optimizer, copies."""

from port_bench.harness import is_port_kernel


def read(record):
    return record.device_ms_per_call(lambda name: not is_port_kernel(name))
