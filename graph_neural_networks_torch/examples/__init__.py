"""Drivers of the PyTorch port (``python -m
graph_neural_networks_torch.examples.<name>``)."""
