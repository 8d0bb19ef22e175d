"""The plain reference: exact nearest neighbours, distances and filters in
plain PyTorch and NumPy. It imports nothing of the program and takes only
the generators' arrays."""
