"""Weight carrying and checkpoint loading."""
