"""NN primitives with the reference PyTorch parameter names."""

from se_tpu_torch.nn.activations import Dropout, PReLU
from se_tpu_torch.nn.complex_ops import (
    ComplexConv2d, ComplexConvTranspose2d, ComplexDense, NaiveComplexLSTM,
)
from se_tpu_torch.nn.conv import (
    Conv1d, Conv2d, ConvParams, ConvTranspose2d, GluConv2d,
    GluConvTranspose2d, Linear, ShareSepConv,
)
from se_tpu_torch.nn.norms import (
    BatchNorm, ChannelWiseLayerNorm, CumulativeLayerNorm1d,
    CumulativeLayerNorm2d, FrameLayerNorm, InstanceNorm, InstanceNorm1d, InstanceNorm2d, LayerNorm,
    OnePassLayerNorm, SeqCausalLayerNorm, SeqLayerNorm, deepxi_normalisation,
)
from se_tpu_torch.nn.recurrent import LSTM, lstm_layer

__all__ = ["BatchNorm", "ChannelWiseLayerNorm", "ComplexConv2d",
           "ComplexConvTranspose2d", "ComplexDense", "Conv1d", "Conv2d", "ConvParams",
           "ConvTranspose2d", "CumulativeLayerNorm1d",
           "CumulativeLayerNorm2d", "Dropout", "FrameLayerNorm",
           "GluConv2d", "GluConvTranspose2d", "InstanceNorm",
           "InstanceNorm1d", "InstanceNorm2d", "LSTM", "LayerNorm", "Linear",
           "NaiveComplexLSTM", "OnePassLayerNorm", "PReLU",
           "SeqCausalLayerNorm", "SeqLayerNorm", "ShareSepConv",
           "deepxi_normalisation", "lstm_layer"]
