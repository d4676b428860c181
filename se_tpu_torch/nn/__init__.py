"""NN primitives with the reference PyTorch parameter names."""

from se_tpu_torch.nn.activations import Dropout, PReLU
from se_tpu_torch.nn.complex_ops import (
    ComplexConv2d, ComplexConvTranspose2d, ComplexDense, NaiveComplexLSTM,
)
from se_tpu_torch.nn.conv import (
    Conv2d, ConvParams, ConvTranspose2d, GluConv2d, GluConvTranspose2d,
    Linear,
)
from se_tpu_torch.nn.norms import BatchNorm, LayerNorm
from se_tpu_torch.nn.recurrent import LSTM, lstm_layer

__all__ = ["BatchNorm", "ComplexConv2d", "ComplexConvTranspose2d",
           "ComplexDense", "Conv2d", "ConvParams", "ConvTranspose2d",
           "Dropout", "GluConv2d", "GluConvTranspose2d", "LSTM", "LayerNorm",
           "Linear", "NaiveComplexLSTM", "PReLU", "lstm_layer"]
