"""mfu_pct.train (%; layer: whole step; moves train_au_s_per_s; the train
cell): the reference's FLOPs a step, forward and backward to every
trained weight, times the steps of the window, over its seconds, over
the peak of the configuration's operand width (peaks.json)."""


def read(record):
    return record.mfu_pct()
