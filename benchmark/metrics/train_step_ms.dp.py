"""``train_step_ms.dp``: ``train_step_ms`` in the cells over several cards,
whose windows wait on every rank's host and so carry a bound of their
own (ms; rank 0's window)."""

from benchmark.harness import spec

read = spec.metric_reader("train_step_ms")
