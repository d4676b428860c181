"""kernel_device_ms.enhance (ms; layer: kernels; moves
enhance_au_s_per_s; the enhance cells): device ms a call in the port's
own csrc kernels, matched by the start of the kernel's name: lstm_,
att_, dsconv_, encoder_level, decoder_level, stft_."""

from port_bench.harness import is_port_kernel


def read(record):
    return record.device_ms_per_call(is_port_kernel)
