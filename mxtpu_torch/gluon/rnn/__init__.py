"""gluon.rnn — recurrent layers and cells (port of ``mxtpu/gluon/rnn``)."""

from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN
