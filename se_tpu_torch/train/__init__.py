"""Training: masked losses, the train step, checkpoints."""
