"""The BCNN's training half: the optimizer, step-atomic checkpoints and
the restartable trainer."""
