"""Job entry points of the PyTorch port."""
