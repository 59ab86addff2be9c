"""The system under test as the harness drives it: a trainer of the port
and the state it steps. ``step`` is the window's own call, the trainer's
``train_step``; the harness reads nothing else of the program but its
parameters and its optimizer's state (for the comparison) and the
kernels and ops the profiler names."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class Subject:
    trainer: Any
    state: dict

    def step(self, images, labels) -> dict:
        """One train step; returns the trainer's metrics (0-d tensors, not
        read inside the window)."""
        _, metrics = self.trainer.train_step(self.state, images, labels)
        return metrics

    @property
    def model(self):
        return self.state["model"]

    @property
    def opt(self):
        return self.state["opt"]

    def params(self) -> list:
        """The parameters in the model's order (whole: the cells' meshes
        split the batch only)."""
        return list(self.model.parameters())
