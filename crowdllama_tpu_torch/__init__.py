"""PyTorch/CUDA port of the crowdllama-tpu engine for NVIDIA Hopper.

A package beside ``crowdllama_tpu`` (the JAX reference), importing
nothing of it.  Module paths mirror the JAX package.
"""
