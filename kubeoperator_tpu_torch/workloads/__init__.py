"""Workloads of the PyTorch port: the transformer LM slice."""
