"""Data layer: dataset base classes and the task datasets (numpy on the
host; the Trainer moves each batch to the device), and the flocking
environment, whose training store (``Flocking.large_device``) lives on the
device."""

from graph_neural_networks_torch.data.base import (  # noqa: F401
    Data, DataForClassification, change_data_type, invert_tensor_ew,
    normalize_data)
from graph_neural_networks_torch.data.datasets import (  # noqa: F401
    Authorship, Epidemics, FacebookEgo, MovieLens, SourceLocalization,
    TwentyNews, distance_sklearn_metrics, knn_adjacency,
    replace_random_edges)
from graph_neural_networks_torch.data.flocking import Flocking  # noqa: F401
