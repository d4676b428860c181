"""forward_idle_ms.train (ms; layer: trainer; moves train_au_s_per_s; the
train cell): device-idle ms a step while the port's `train.forward` span
(the forward and loss, `train.prep` inside) is open and no
`autograd.twin` is."""

from port_bench.spans import idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, ("train.forward",),
                            without=("autograd.twin",))
