"""Telemetry of the PyTorch port: the serving-plane metric families."""
