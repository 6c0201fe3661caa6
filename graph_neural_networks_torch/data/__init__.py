"""Data layer: dataset base classes and the ported task datasets (numpy on
the host; the Trainer moves each batch to the device), and the flocking
environment, whose training store (``Flocking.large_device``) lives on the
device."""

from graph_neural_networks_torch.data.base import (  # noqa: F401
    Data, DataForClassification)
from graph_neural_networks_torch.data.datasets import (  # noqa: F401
    SourceLocalization)
from graph_neural_networks_torch.data.flocking import Flocking  # noqa: F401
