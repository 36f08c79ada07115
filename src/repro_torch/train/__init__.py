"""Training substrate: optimizers, train step, data, checkpointing, fault tolerance."""
