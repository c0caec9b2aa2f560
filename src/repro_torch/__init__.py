"""PyTorch + CUDA port of the RcLLM reproduction (the JAX package `repro`
is the reference).  Imports torch and numpy, never jax or `repro`."""
