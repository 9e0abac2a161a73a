"""bin of the PyTorch port."""
