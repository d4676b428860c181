"""backward_idle_ms.train (ms; layer: autograd; moves train_au_s_per_s;
the train cell): device-idle ms a step while the port's `train.backward`
span (`loss.backward()`) is open and no `autograd.twin` is: the backward
of the plain torch ops."""

from port_bench.spans import idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, ("train.backward",),
                            without=("autograd.twin",))
