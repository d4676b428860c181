"""model_idle_ms.enhance (ms; layer: models and nn; moves
enhance_au_s_per_s; the enhance cells): device-idle ms a call while the
port's `enhance.model` span (`_enhance`: STFT, network, iSTFT) or a span
under it is open: the launch-paced gaps inside the network."""

from port_bench.spans import idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, ("enhance.model",))
