"""repro_torch — the PyTorch/CUDA port of the PruneX reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``kernels``, ``core``, ``comm``, ``models``,
``data``, ``train``) and imports nothing of it.  Entry points run on the
CUDA card unless the caller asks for the CPU (``device="cpu"``), where
every hand-written kernel's wrapper takes its plain PyTorch version.

Importing the package fixes cuBLAS's workspace (``CUBLAS_WORKSPACE_CONFIG``,
unless the user set it), so that every matrix product on the card is
deterministic: cuBLAS reads the setting once, when the first product
creates its handle, which may come before any ``Engine`` exists.
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
