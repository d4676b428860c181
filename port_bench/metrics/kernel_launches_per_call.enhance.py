"""kernel_launches_per_call.enhance (launches; layer: kernels; moves
enhance_au_s_per_s; the enhance cells): the port's kernel launches a
call, each once: the `kernel.launch` spans (ops/_build.py `launch`), one
for each launch that `_build.LAUNCHES` counts under its kernel's key (its
`attention_<design>` and `*_bf16_widened` keys count a launch again)."""

from port_bench.spans import count_per_call


def read(record):
    return count_per_call(record, lambda name: name == "kernel.launch")
