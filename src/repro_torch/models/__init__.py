"""Model code of the port: the dense-attention family so far."""
