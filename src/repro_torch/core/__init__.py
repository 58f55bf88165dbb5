"""PruneX core of the port: H-SADMM, structured sparsity, coupling, masks,
shrinkage, consensus (modules mirror ``repro.core``)."""
