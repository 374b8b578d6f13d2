"""audio of the PyTorch port."""
