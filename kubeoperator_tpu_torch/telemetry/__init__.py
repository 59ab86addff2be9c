"""Telemetry of the PyTorch port: the metric families (``metrics``), serve
request span trees (``tracing``, ``serve_trace``) and the gateway's
flight recorder (``flight``)."""
