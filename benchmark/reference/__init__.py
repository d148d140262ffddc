"""The benchmark's plain reference: PyTorch and NumPy only, independent of
the measured program."""
