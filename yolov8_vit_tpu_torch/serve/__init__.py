"""serve of the PyTorch port."""
