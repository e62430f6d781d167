"""Data sources. Only the hermetic synthetic dataset is ported so far."""
