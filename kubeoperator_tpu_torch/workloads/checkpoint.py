"""Workload checkpoint and resume on ``torch.save``: the counterpart of
``kubeoperator_tpu/workloads/checkpoint.py`` (``WorkloadCheckpointer``),
so a preempted training pod continues where its last checkpoint left it.

A checkpoint is one file per step, ``step_<N>.pt`` under the directory,
holding the step, the model's ``state_dict`` (params and BatchNorm
buffers) and the optimizer's ``state_dict``. Each save is written under a
temporary name, synced to disk, renamed over its final one and the
rename synced, so neither a process killed mid-save nor a lost node
leaves a partial checkpoint that ``latest_step`` would return. A
checkpointer's first save removes the temporary files of saves cut
short: a directory has one writer, the training job. The newest
``max_to_keep`` checkpoints are kept, as the reference's orbax
``CheckpointManager`` keeps them. Restoring the latest checkpoint falls
back to the next older one when a file cannot be read.

The format is the port's own: it does not read the reference's orbax
checkpoints, and the reference does not read these.
"""

from __future__ import annotations

import os
import pickle
import re
import warnings
import zipfile

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")
_TMP = re.compile(r"^\.step_\d+\.pt\.tmp\d+$")
# what torch.load raises for a truncated or corrupted file
_UNREADABLE = (OSError, RuntimeError, EOFError, pickle.UnpicklingError,
               zipfile.BadZipFile)


class WorkloadCheckpointer:
    """Save and restore a trainer state ``{"step", "model", "opt"}`` (the
    port's ``LMTrainer``, ``Trainer`` and ``ViTTrainer`` states) under
    ``directory``, keeping the newest ``max_to_keep`` (at least 1)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._swept = False
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self) -> list[int]:
        """The steps with a complete checkpoint, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` as the checkpoint of ``step`` (replacing one of
        the same step), then drop all but the newest ``max_to_keep``."""
        if not self._swept:
            for name in os.listdir(self.directory):
                if _TMP.match(name):
                    os.remove(os.path.join(self.directory, name))
            self._swept = True
        final = self.path(step)
        tmp = os.path.join(self.directory,
                           f".step_{int(step)}.pt.tmp{os.getpid()}")
        with open(tmp, "wb") as f:
            torch.save({"step": int(step),
                        "model": state["model"].state_dict(),
                        "opt": state["opt"].state_dict()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        dir_fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _load(self, step: int | None, device, mmap: bool = False) -> dict:
        """The saved dict of ``step``; for ``None`` the newest that can be
        read, warning of each newer one that cannot."""
        def load(at):
            return torch.load(self.path(at), map_location=device,
                              weights_only=True, mmap=mmap)

        if step is not None:
            return load(step)
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        for newer in reversed(steps[1:]):
            try:
                return load(newer)
            except _UNREADABLE as e:
                warnings.warn(f"checkpoint {self.path(newer)} cannot be "
                              f"read ({e!r}); trying the one before it")
        return load(steps[0])

    def restore(self, state: dict, step: int | None = None) -> dict:
        """Load the checkpoint of ``step`` (default the latest that can be
        read) into ``state`` in place, on the device of its model, and
        return it. Raises ``FileNotFoundError`` when the directory holds
        none."""
        device = next(state["model"].parameters()).device
        saved = self._load(step, device)
        state["model"].load_state_dict(saved["model"])
        state["opt"].load_state_dict(saved["opt"])
        state["step"] = saved["step"]
        return state

    def restore_model(self, model: torch.nn.Module,
                      step: int | None = None) -> int:
        """Load only the model's weights of ``step`` (default the latest
        that can be read) into ``model`` in place and return the step.
        The file is mapped on the host, so the optimizer's state never
        reaches the model's device."""
        saved = self._load(step, "cpu", mmap=True)
        model.load_state_dict(saved["model"])
        return saved["step"]

    def close(self) -> None:
        """Nothing is left pending: every save is complete on return."""
