"""twin_idle_ms.train (ms; layer: autograd; moves train_au_s_per_s; the
train cell): device-idle ms a step while an `autograd.twin` span is open:
ops/_autograd.py's backward, the plain twin recomputed and its VJP."""

from port_bench.spans import idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, ("autograd.twin",))
