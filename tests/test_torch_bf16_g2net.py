"""G2Net's bf16 enhance against se_tpu's on the CPU, in both norm
variants, through its inverted RMS gain (the input divided by c, the
output multiplied): tests/test_torch_bf16_tcm.py's check, in a file of its
own so that each file runs within a minute."""

import pytest

from test_torch_bf16_tcm import _one_thread, check_family  # noqa: F401


@pytest.mark.parametrize("norm", ["cln", "in"])
def test_g2net_bf16_enhance_tracks_se_tpu(record_property, norm):
    check_family("g2net", norm, record_property)
