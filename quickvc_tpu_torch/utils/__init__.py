"""Weight carrying, checkpoint loading and training checkpoints."""
