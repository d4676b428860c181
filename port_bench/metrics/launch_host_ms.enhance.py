"""launch_host_ms.enhance (ms; layer: kernels; moves enhance_au_s_per_s;
the enhance cells): host ms a call inside the port's `kernel.launch`
spans (ops/_build.py `launch`: argument conversion, stream lookup,
`se_set_device` and the C call)."""

from port_bench.spans import host_ms_per_call


def read(record):
    return host_ms_per_call(record, "kernel.launch")
