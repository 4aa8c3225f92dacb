"""Plain references of the benchmark's cells: plain PyTorch and NumPy,
importing nothing of the program."""
