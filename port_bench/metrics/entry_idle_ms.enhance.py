"""entry_idle_ms.enhance (ms; layer: entry; moves enhance_au_s_per_s;
the enhance cells): device-idle ms a call while the port's `enhance` span
is open and `enhance.model` is not: the deepest open span is `enhance`,
`enhance.gain` (the numpy RMS gain), `enhance.h2d`, `enhance.d2h` (the
copies' host side) or `enhance.ungain` (the gain's removal)."""

from port_bench.spans import idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, ("enhance",), without=("enhance.model",))
