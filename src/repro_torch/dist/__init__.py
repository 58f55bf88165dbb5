"""``repro_torch.dist`` — the port's distributed-runtime layer (port of
``repro.dist``'s checkpoint, fault-tolerance and monitor modules).

* :mod:`repro_torch.dist.checkpoint`: atomic directory-swap checkpoints
  with a background writer thread and *elastic* restore, in the JAX
  package's on-disk layout,
* :mod:`repro_torch.dist.ft`: composable failure/straggler policies
  producing the consensus weight vectors that make worker loss a no-op,
  and class-scoped ones for per-coupling-class weights,
* :mod:`repro_torch.dist.monitor`: kernel-build and call counters
  guarding the round contract.

The compiled-HLO introspection and the fabric tables of ``repro.dist``
have no counterpart yet.
"""
from . import checkpoint, ft, monitor
from .monitor import CallCounter, compile_count, counting, probe_seconds

__all__ = ["checkpoint", "ft", "monitor", "CallCounter", "compile_count",
           "counting", "probe_seconds"]
