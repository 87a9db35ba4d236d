"""Training: the optimizer, step-atomic checkpoints, the BCNN's
restartable trainer, the LM zoo's train step and elastic shard
assignment."""
