"""packs_made_per_call.enhance (packs; layer: kernels; moves
enhance_au_s_per_s; the enhance cells): weight packs made a call, counted
as the port's pack spans in the window: each pack is a span named by its
pack function (`pack_weights`, `pack_input`, ...; ops/_build.py
`packs`)."""

from port_bench.spans import count_per_call


def read(record):
    return count_per_call(record, lambda name: name.startswith("pack_"))
