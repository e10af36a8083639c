"""Networks, layers, activations and weight initialization."""
