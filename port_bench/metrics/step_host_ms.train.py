"""step_host_ms.train (ms; layer: trainer; moves train_au_s_per_s; the
train cell): ms a step in which the device runs no operation inside the
benchmark's span around `step_fn` and its `loss.item()`."""


def read(record):
    return record.host_ms_per_call()
