"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (``ref``) and the dispatch shims (``ops``)."""
