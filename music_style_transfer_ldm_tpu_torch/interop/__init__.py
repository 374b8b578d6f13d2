"""interop of the PyTorch port."""
