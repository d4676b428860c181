"""device_idle_pct.enhance (%; layer: device; moves enhance_au_s_per_s;
the enhance cells): the share of the traced window in which no kernel or
copy runs on the device."""


def read(record):
    return record.idle_pct()
