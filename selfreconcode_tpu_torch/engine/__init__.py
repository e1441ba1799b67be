"""Surface solve, losses, IGR pretraining, training step, checkpoints."""
