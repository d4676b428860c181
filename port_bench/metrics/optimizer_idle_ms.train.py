"""optimizer_idle_ms.train (ms; layer: trainer; moves train_au_s_per_s;
the train cell): device-idle ms a step while the port's `train.optimizer`
span (the gradient dict, the clip and Adam's per-leaf loop) is open."""

from port_bench.spans import idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, ("train.optimizer",))
