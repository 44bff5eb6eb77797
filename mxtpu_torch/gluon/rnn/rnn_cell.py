"""RNN cells — port of ``mxtpu/gluon/rnn/rnn_cell.py``: ``RNNCell``,
``LSTMCell``, ``GRUCell``, ``SequentialRNNCell``, ``DropoutCell``,
``ModifierCell``, ``ZoneoutCell``, ``ResidualCell``,
``BidirectionalCell``, ``HybridRecurrentCell`` and ``unroll``.

A cell is a layer of the port (its forward computes on tensors):
``cell(inputs, states) -> (out, next_states)`` with NDArrays records one
node, with tensors it is a torch module call. Parameter names are the
reference's (``i2h_weight``, ``h2h_weight``, ``i2h_bias``,
``h2h_bias``), the input width deferred to the first step. ``unroll``
steps the cell over time on NDArrays or tensors alike; ``valid_length``
masks the outputs past each sequence's length through ``SequenceMask``.
The dropout and zoneout cells draw their masks as ``nd.Dropout`` does
(``ops.nn._dropout``: a ``rng.device_seeds`` scope, else the device's
generator), in training only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ... import ndarray as nd
from ...ndarray.ndarray import NDArray
from ...ops import nn as _ops
from ...ops.sequence import _sequence_mask
from ..nn.basic_layers import _Layer

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _steps(inputs, length: int, axis: int) -> list:
    """``inputs`` (an array with time on ``axis``, or a list of steps) as
    a list of ``length`` steps."""
    if isinstance(inputs, NDArray):
        if length == 1:
            return [inputs.squeeze(axis)]
        return list(nd.split(inputs, num_outputs=length, axis=axis,
                             squeeze_axis=True))
    if isinstance(inputs, torch.Tensor):
        return list(inputs.unbind(axis))
    return list(inputs)


def _stack(steps: list, axis: int):
    if isinstance(steps[0], NDArray):
        return nd.stack(*steps, axis=axis)
    return torch.stack(steps, axis)


def _masked(outputs: list, valid_length, length: int) -> list:
    """The steps past each sequence's ``valid_length`` zeroed."""
    stacked = _stack(outputs, 0)                   # (T, N, C)
    if isinstance(stacked, NDArray):
        masked = nd.SequenceMask(stacked, valid_length,
                                 use_sequence_length=True)
    else:
        masked = _sequence_mask(stacked, valid_length, True)
    return [masked[t] for t in range(length)]


class RecurrentCell(_Layer):
    """Base of the cells: ``state_info``, ``begin_state``, ``reset`` and
    ``unroll``."""

    def state_info(self, batch_size: int = 0):
        raise NotImplementedError

    def begin_state(self, batch_size: int = 0, func=None, **kwargs):
        func = func or nd.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def reset(self):
        pass

    def __call__(self, inputs, states):
        return super().__call__(inputs, list(states))

    def unroll(self, length: int, inputs, begin_state=None,
               layout: str = "NTC", merge_outputs: Optional[bool] = None,
               valid_length=None):
        """Step the cell ``length`` times (``BaseRNNCell.unroll``)."""
        axis = layout.find("T")
        steps = _steps(inputs, length, axis)
        states = begin_state if begin_state is not None \
            else self.begin_state(steps[0].shape[0])
        outputs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
        if valid_length is not None:
            outputs = _masked(outputs, valid_length, length)
        if merge_outputs:
            outputs = _stack(outputs, axis)
        return outputs, states


class HybridRecurrentCell(RecurrentCell):
    pass


class _GatedCell(RecurrentCell):
    """The parameters of a cell with ``gates`` blocks of ``hidden_size``."""

    def __init__(self, hidden_size: int, gates: int, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size: int, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._rows = g = gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get("i2h_bias", shape=(g,),
                                            init=i2h_bias_initializer)
            self.h2h_bias = self.params.get("h2h_bias", shape=(g,),
                                            init=h2h_bias_initializer)

    def state_info(self, batch_size: int = 0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _products(self, inputs, h):
        """``(inputs . i2h_weight^T + i2h_bias, h . h2h_weight^T +
        h2h_bias)``, completing the deferred input width."""
        w = self._ready("i2h_weight", (self._rows, inputs.shape[-1]))
        return (F.linear(inputs, w, self._ready("i2h_bias")),
                F.linear(h, self._ready("h2h_weight"),
                         self._ready("h2h_bias")))


class RNNCell(_GatedCell):
    def __init__(self, hidden_size: int, activation: str = "tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size: int = 0, prefix=None, params=None):
        super().__init__(hidden_size, 1, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states[0])
        out = _ops._activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    def __init__(self, hidden_size: int, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size: int = 0,
                 prefix=None, params=None):
        super().__init__(hidden_size, 4, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size: int = 0):
        return super().state_info(batch_size) * 2

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, 1)
        next_c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) \
            * torch.tanh(g)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    def __init__(self, hidden_size: int, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size: int = 0,
                 prefix=None, params=None):
        super().__init__(hidden_size, 3, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def forward(self, inputs, states):
        ix, ih = self._products(inputs, states[0])
        ir, iz, inn = ix.chunk(3, 1)
        hr, hz, hn = ih.chunk(3, 1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        next_h = (1 - z) * n + z * states[0]
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each cell's output is the next one's input."""

    def add(self, cell):
        self.register_child(cell)

    def _cells(self):
        return self._child_blocks()

    def state_info(self, batch_size: int = 0):
        return [info for c in self._cells()
                for info in c.state_info(batch_size)]

    def begin_state(self, batch_size: int = 0, **kwargs):
        return [s for c in self._cells()
                for s in c.begin_state(batch_size, **kwargs)]

    def forward(self, inputs, states):
        next_states, pos = [], 0
        for cell in self._cells():
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[pos:pos + n])
            next_states += st
            pos += n
        return inputs, next_states

    def __len__(self):
        return len(self._cells())


class DropoutCell(RecurrentCell):
    """Dropout on the inputs, in training."""

    def __init__(self, rate: float, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size: int = 0):
        return []

    def forward(self, inputs, states):
        return _ops._dropout(inputs, p=self._rate, axes=self._axes,
                             _training=self.training), states


class ModifierCell(RecurrentCell):
    """A cell around ``base_cell``, whose parameters and states it has."""

    def __init__(self, base_cell: RecurrentCell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size: int = 0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size: int = 0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)

    def collect_params(self, select=None):
        return self.base_cell.collect_params(select)


def _keep_mask(like, rate: float) -> torch.Tensor:
    """Where a dropout of ones at ``rate`` keeps the element."""
    return _ops._dropout(torch.ones_like(like), p=rate, _training=True) != 0


class ZoneoutCell(ModifierCell):
    """Zoneout: in training each output (state) keeps its previous value
    where a dropout at ``zoneout_outputs`` (``zoneout_states``) drops."""

    def __init__(self, base_cell, zoneout_outputs: float = 0.0,
                 zoneout_states: float = 0.0):
        super().__init__(base_cell)
        self._zo, self._zs = zoneout_outputs, zoneout_states
        self._prev_output = None

    def reset(self):
        self._prev_output = None

    def forward(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        if self.training:
            if self._zo > 0:
                prev = self._prev_output if self._prev_output is not None \
                    else torch.zeros_like(out)
                out = torch.where(_keep_mask(out, self._zo), out, prev)
            if self._zs > 0:
                next_states = [torch.where(_keep_mask(ns, self._zs), ns, s)
                               for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class ResidualCell(ModifierCell):
    def forward(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        return out + inputs, next_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward in time, their outputs
    concatenated; it can only be unrolled."""

    def __init__(self, l_cell, r_cell, output_prefix: str = "bi_"):
        super().__init__()
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size: int = 0):
        return (self._modules["l_cell"].state_info(batch_size)
                + self._modules["r_cell"].state_info(batch_size))

    def begin_state(self, batch_size: int = 0, **kwargs):
        return (self._modules["l_cell"].begin_state(batch_size, **kwargs)
                + self._modules["r_cell"].begin_state(batch_size, **kwargs))

    def __call__(self, inputs, states):
        # as the reference (gluon/rnn/rnn_cell.py:1007): a bidirectional
        # readout at step t needs the steps after it
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        l_cell, r_cell = self._modules["l_cell"], self._modules["r_cell"]
        steps = _steps(inputs, length, axis)
        states = begin_state if begin_state is not None \
            else self.begin_state(steps[0].shape[0])
        nl = len(l_cell.state_info())
        l_outs, l_states = l_cell.unroll(length, steps, states[:nl],
                                         layout="NTC", merge_outputs=False)
        r_outs, r_states = r_cell.unroll(length, list(reversed(steps)),
                                         states[nl:], layout="NTC",
                                         merge_outputs=False)
        outs = [nd.concat(lo, ro, dim=1) if isinstance(lo, NDArray)
                else torch.cat((lo, ro), 1)
                for lo, ro in zip(l_outs, reversed(r_outs))]
        if merge_outputs:
            outs = _stack(outs, axis)
        return outs, list(l_states) + list(r_states)

