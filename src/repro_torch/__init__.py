"""PyTorch and CUDA port of the DQF reproduction (see ``repro`` for the JAX reference)."""
