"""device_idle_pct.train (%; layer: device; moves train_au_s_per_s; the
train cell): the share of the traced window in which no kernel or copy
runs on the device."""


def read(record):
    return record.idle_pct()
