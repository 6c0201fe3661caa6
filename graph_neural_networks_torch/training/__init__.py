"""Training and evaluation: losses, Model (Best/Last checkpoints), Trainer,
TrainerSingleNode (the loss at each sample's target node), TrainerFlocking
(the host and device DAGger stores) and the evaluators, ported from the JAX
package's ``training/``."""

from graph_neural_networks_torch.training import losses  # noqa: F401
from graph_neural_networks_torch.training.evaluation import (  # noqa: F401
    evaluate, evaluate_flocking, evaluate_single_node, evaluateFlocking,
    evaluateSingleNode)
from graph_neural_networks_torch.training.model import (  # noqa: F401
    Model, make_optimizer)
from graph_neural_networks_torch.training.trainer import (  # noqa: F401
    Trainer, TrainerFlocking, TrainerSingleNode)
