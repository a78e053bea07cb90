"""Host audio I/O (numpy/scipy)."""
