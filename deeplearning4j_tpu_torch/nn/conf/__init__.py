"""Config DSL: layers, input types and the network configuration."""
