"""datasets of the PyTorch port."""
