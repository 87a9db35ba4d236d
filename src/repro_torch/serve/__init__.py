"""Online serving of the packed BCNN: the slot scheduler and the engine."""
