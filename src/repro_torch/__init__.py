"""PyTorch/CUDA port of the APEX serving system (the JAX package `repro` is the reference)."""
