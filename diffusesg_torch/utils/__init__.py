"""Device policy, weight carry-over, logging and checkpoints."""
