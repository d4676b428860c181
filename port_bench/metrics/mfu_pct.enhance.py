"""mfu_pct.enhance (%; layer: whole step; moves enhance_au_s_per_s; the
enhance cells): the reference's FLOPs a call (flops/<family>.py
`model_flops`) times the calls of the window, over its seconds, over the
peak of the configuration's operand width (peaks.json)."""


def read(record):
    return record.mfu_pct()
