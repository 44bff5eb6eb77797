"""Contrib RNN cells — port of ``mxtpu/gluon/contrib/rnn.py``:
``VariationalDropoutCell``, one dropout mask a sequence (variational) on
the inputs, the hidden state and the outputs, in training only.

The masks are drawn at a sequence's first step and kept until ``reset``
(which ``unroll`` calls first), as ``nd.Dropout`` draws them
(``ops.nn._dropout``). Only ``states[0]`` is masked (the hidden state,
not an LSTM's cell memory), as the reference's.
"""

from __future__ import annotations

import torch

from ...ops import nn as _ops
from ..rnn.rnn_cell import ModifierCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    def __init__(self, base_cell, drop_inputs: float = 0.0,
                 drop_states: float = 0.0, drop_outputs: float = 0.0):
        super().__init__(base_cell)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self.reset()

    def reset(self):
        self._mask_in = None
        self._mask_state = None
        self._mask_out = None
        self.base_cell.reset()

    def _mask(self, attr: str, rate: float, arr):
        if rate == 0.0 or not self.training:
            return arr
        mask = getattr(self, attr)
        if mask is None or mask.shape != arr.shape:
            mask = _ops._dropout(torch.ones_like(arr), p=rate,
                                 _training=True)
            setattr(self, attr, mask)
        return arr * mask

    def forward(self, inputs, states):
        inputs = self._mask("_mask_in", self._di, inputs)
        if self._ds:
            states = [self._mask("_mask_state", self._ds, states[0])] \
                + list(states[1:])
        out, next_states = self.base_cell(inputs, states)
        return self._mask("_mask_out", self._do, out), next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs, valid_length)
