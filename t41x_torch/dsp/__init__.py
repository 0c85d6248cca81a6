"""Signal-processing stages in torch (design-time parts in NumPy)."""
