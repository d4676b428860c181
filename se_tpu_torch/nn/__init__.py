"""NN primitives with the reference PyTorch parameter names."""

from se_tpu_torch.nn.activations import PReLU
from se_tpu_torch.nn.complex_ops import ComplexDense
from se_tpu_torch.nn.conv import ConvParams, Linear
from se_tpu_torch.nn.norms import BatchNorm, LayerNorm
from se_tpu_torch.nn.recurrent import LSTM, lstm_layer

__all__ = ["BatchNorm", "ComplexDense", "ConvParams", "LSTM", "LayerNorm",
           "Linear", "PReLU", "lstm_layer"]
