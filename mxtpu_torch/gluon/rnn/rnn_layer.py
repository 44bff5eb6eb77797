"""Fused RNN layers — port of ``mxtpu/gluon/rnn/rnn_layer.py``: ``RNN``,
``LSTM`` and ``GRU`` (``num_layers``, ``bidirectional``, dropout between
layers, ``TNC``/``NTC`` layout, ``begin_state``, ``state_info``).

The parameters are the reference's, ``{l,r}{layer}_{i2h,h2h}_{weight,
bias}``, with the first layer's ``input_size`` deferred to the first
forward. The forward runs ``ops.rnn.run_layers`` (``rnn_scan`` a layer
and direction) on tensors. Called without states it starts from zeros and
returns the output alone; called with states it returns ``(out,
states)``. Dropout between layers draws from the layer's ``seed`` (a 0-d
int64 device tensor that ``DataParallelTrainer`` sets every micro-batch,
as for ``nn.Dropout``: a captured step draws new masks on every replay),
else from a ``rng.device_seeds`` scope, else from the device's generator.
"""

from __future__ import annotations

from typing import List

import torch

from ... import ndarray as nd
from ...ops.rnn import _GATES, run_layers
from ..nn.basic_layers import _Layer

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(_Layer):
    _device_seeded = True

    def __init__(self, hidden_size: int, num_layers: int, layout: str,
                 dropout: float, bidirectional: bool, input_size: int,
                 mode: str, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"layout {layout!r}: use 'TNC' or 'NTC'")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self._gates = _GATES[mode]
        self.seed = None
        ng, h = self._gates, hidden_size
        with self.name_scope():
            for layer in range(num_layers):
                for suffix in ["l", "r"][:self._dir]:
                    isz = input_size if layer == 0 else h * self._dir
                    pre = f"{suffix}{layer}_"
                    setattr(self, pre + "i2h_weight", self.params.get(
                        pre + "i2h_weight", shape=(ng * h, isz),
                        init=i2h_weight_initializer,
                        allow_deferred_init=True))
                    setattr(self, pre + "h2h_weight", self.params.get(
                        pre + "h2h_weight", shape=(ng * h, h),
                        init=h2h_weight_initializer))
                    setattr(self, pre + "i2h_bias", self.params.get(
                        pre + "i2h_bias", shape=(ng * h,),
                        init=i2h_bias_initializer))
                    setattr(self, pre + "h2h_bias", self.params.get(
                        pre + "h2h_bias", shape=(ng * h,),
                        init=h2h_bias_initializer))

    def state_info(self, batch_size: int = 0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def begin_state(self, batch_size: int = 0, func=None,
                    **kwargs) -> List:
        func = func or nd.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _weights(self, input_size: int):
        """``weights[layer][dir]``, completing the deferred input widths."""
        ng, h = self._gates, self._hidden_size
        out = []
        for layer in range(self._num_layers):
            isz = input_size if layer == 0 else h * self._dir
            row = []
            for suffix in ["l", "r"][:self._dir]:
                pre = f"{suffix}{layer}_"
                row.append((self._ready(pre + "i2h_weight", (ng * h, isz)),
                            self._ready(pre + "i2h_bias"),
                            self._ready(pre + "h2h_weight"),
                            self._ready(pre + "h2h_bias")))
            out.append(row)
        return out

    def forward(self, inputs, states=None):
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        weights = self._weights(inputs.shape[2])
        ret_states = states is not None
        if states is None:
            z = torch.zeros((self._num_layers * self._dir, inputs.shape[1],
                             self._hidden_size), dtype=inputs.dtype,
                            device=inputs.device)
            states = [z, z] if self._mode == "lstm" else [z]
        elif isinstance(states, torch.Tensor):
            states = [states]
        lstm = self._mode == "lstm"
        out, hs, cs = run_layers(inputs, states[0],
                                 states[1] if lstm else None, weights,
                                 self._mode, self._dropout, self.training,
                                 self.seed)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if not ret_states:
            return out
        return out, [torch.stack(hs)] + ([torch.stack(cs)] if lstm else [])

    def __call__(self, inputs, states=None):
        if states is None:
            return super().__call__(inputs)
        return super().__call__(inputs, states)


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (relu or tanh)."""

    def __init__(self, hidden_size: int, num_layers: int = 1,
                 activation: str = "relu", layout: str = "TNC",
                 dropout: float = 0.0, bidirectional: bool = False,
                 input_size: int = 0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, f"rnn_{activation}",
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size: int, num_layers: int = 1,
                 layout: str = "TNC", dropout: float = 0.0,
                 bidirectional: bool = False, input_size: int = 0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size: int, num_layers: int = 1,
                 layout: str = "TNC", dropout: float = 0.0,
                 bidirectional: bool = False, input_size: int = 0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
