"""``device_idle.dp``: ``device_idle`` in the cells over several cards,
where it moves ``train_step_ms.dp`` (%; rank 0's card)."""

from benchmark.harness import spec

read = spec.metric_reader("device_idle")
