"""Host audio I/O and the training data pipeline (numpy/scipy)."""
