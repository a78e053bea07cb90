"""Weight carrying, checkpoint loading, training checkpoints and the run device."""
