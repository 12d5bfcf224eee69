"""One-device train and eval steps and the optimizers; data parallelism is
ROADMAP A9."""
