"""entry_host_ms.enhance (ms; layer: entry; moves enhance_au_s_per_s;
the enhance cells): ms a call in which the device runs no operation
inside the benchmark's span around `enhance_waveform`: the RMS gain, the
copies' host side, the launches and numpy."""


def read(record):
    return record.host_ms_per_call()
