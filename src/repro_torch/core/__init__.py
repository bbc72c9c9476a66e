"""repro_torch.core — transactions, workloads, the CC plan, the execution
wavefront, the engine and state carried across (port of ``repro.core``)."""
