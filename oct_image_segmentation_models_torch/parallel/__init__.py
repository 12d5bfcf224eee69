"""Train and eval steps, the optimizers and data parallelism over a mesh
of ranks (``torch.distributed``, one process per device)."""
