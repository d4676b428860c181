"""roofline_pct.lstm.enhance (%; layer: kernels; moves
enhance_au_s_per_s; fullsubnet-enhance-b32): the least time of a call's
LSTM layer calls (flops/<family>.py `rooflines`: the larger of their
FLOPs over the peak and their bytes over the bandwidth, a layer call at
a time) over the device time of the kernels named lstm_*, whichever of
them runs a layer."""

from port_bench.harness import kernel_id


def read(record):
    return record.roofline_pct(
        "lstm", lambda name: kernel_id(name).startswith("lstm_"))
