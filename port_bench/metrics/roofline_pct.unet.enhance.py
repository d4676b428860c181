"""roofline_pct.unet.enhance (%; layer: kernels; moves
enhance_au_s_per_s; uformer-enhance-b64): the least time of a call's
twelve U-net levels (flops/<family>.py `rooflines`) over the device time
of the kernels named encoder_level* and decoder_level*."""

from port_bench.harness import kernel_id


def read(record):
    return record.roofline_pct(
        "unet", lambda name: kernel_id(name).startswith(("encoder_level",
                                                         "decoder_level")))
