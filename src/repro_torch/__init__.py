"""repro_torch — the PyTorch/CUDA port of the PruneX reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``kernels``, ``core``, ``comm``, ``models``,
``data``, ``train``) and imports nothing of it.  Entry points run on the
CUDA card unless the caller asks for the CPU (``device="cpu"``), where
every hand-written kernel's wrapper takes its plain PyTorch version.
"""
