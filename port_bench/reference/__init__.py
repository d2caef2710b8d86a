"""Plain references, one module a configuration, in plain PyTorch and
NumPy; none imports the program."""
