"""mxtpu_torch.gluon — the Gluon front end (``Block``, ``Parameter``,
``Trainer``, layers, recurrent layers and cells, losses, utilities), the
model zoo, as torch modules, and ``data`` (datasets, samplers, vision
transforms, ``DataLoader``)."""

from . import loss
from . import nn
from . import rnn
from . import utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

from . import contrib  # noqa: E402
from . import model_zoo  # noqa: E402
from . import data  # noqa: E402

__all__ = ["Block", "Constant", "HybridBlock", "Parameter", "ParameterDict",
           "SymbolBlock", "Trainer", "contrib", "data", "loss", "model_zoo",
           "nn", "rnn", "utils"]
