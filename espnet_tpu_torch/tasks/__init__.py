"""tasks of the PyTorch port."""
