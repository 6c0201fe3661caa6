"""Graph layers and architectures."""
