"""Workload checkpoint and resume on ``torch.save``: the counterpart of
``kubeoperator_tpu/workloads/checkpoint.py`` (``WorkloadCheckpointer``),
so a preempted training pod continues where its last checkpoint left it,
on one device or under a mesh.

A checkpoint is one file per step, ``step_<N>.pt`` under the directory,
and its format knows no layout: the step, {name: whole tensor} of the
model's parameters and buffers (BatchNorm's running statistics), and the
optimizer's state as each parameter's moments by that parameter's name
(whole tensors; scalars such as AdamW's step as they are) beside its
param groups' settings. Under a mesh every rank gathers the shards
(``sharding.unshard_tensor``, a collective over the fsdp, tp and ep
axes that split a tensor: MoE experts too), rank 0 writes the file and
the ranks meet at a barrier; each rank restores the file memory-mapped on
the host and keeps its own shards (``sharding.shard_tensor``). So a
checkpoint moves between mesh shapes, and between a mesh and one device,
as the reference's orbax checkpoints do.

Each save is written under a temporary name, synced to disk, renamed
over its final one and the rename synced, so neither a process killed
mid-save nor a lost node leaves a partial checkpoint that
``latest_step`` would return. A checkpointer's first save removes the
temporary files of saves cut short: a directory has one writer, the
training job's rank 0. The newest ``max_to_keep`` checkpoints are kept,
as the reference's orbax ``CheckpointManager`` keeps them. Restoring the
latest checkpoint falls back to the next older one when a file cannot be
read.

Files of the one-device format written before (the model's and the
optimizer's ``state_dict``s) still restore wherever every parameter is
whole; under fsdp or tp splits they raise. The format is the port's own:
it does not read the reference's orbax checkpoints, and the reference
does not read these.
"""

from __future__ import annotations

import os
import pickle
import re
import warnings
import zipfile

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.workloads import sharding

_NAME = re.compile(r"^step_(\d+)\.pt$")
_TMP = re.compile(r"^\.step_\d+\.pt\.tmp\d+$")
# what torch.load raises for a truncated or corrupted file
_UNREADABLE = (OSError, RuntimeError, EOFError, pickle.UnpicklingError,
               zipfile.BadZipFile)
FORMAT = 2          # the layout-free format; files without the key are 1


def layout_free(step: int, state: dict, placements: dict, mesh) -> dict:
    """The checkpoint of a trainer state ``{"step", "model", "opt"}``
    placed by ``placements`` on ``mesh``, whole tensors on the host by
    name (a collective under a mesh: every rank calls it)."""
    model, opt = state["model"], state["opt"]
    params = dict(sharding.placed_params(model))

    def whole(name, x):
        return sharding.unshard_tensor(x, placements.get(name, ()),
                                       mesh).cpu()

    saved = {name: whole(name, p) for name, p in params.items()}
    # ko: lint-ok[KO102] a save writes every tensor to the host, once per checkpoint and off the step loop
    saved.update({n: b.detach().cpu() for n, b in model.named_buffers()})
    names = _opt_names(opt, params)
    opt_sd = opt.state_dict()
    moments = {}
    for idx in sorted(opt_sd["state"]):
        name = names[idx]
        moments[name] = {
            k: whole(name, v) if _is_moment(v, params[name]) else v
            for k, v in opt_sd["state"][idx].items()}
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": sorted(names[i] for i in g["params"])}
              for g in opt_sd["param_groups"]]
    return {"format": FORMAT, "step": int(step), "model": saved,
            "opt": {"state": moments, "param_groups": groups}}


def _opt_names(opt, params: dict) -> list[str]:
    """The parameter name of each of the optimizer's state indices."""
    by_id = {id(p): name for name, p in params.items()}
    return [by_id[id(p)] for g in opt.param_groups for p in g["params"]]


def _is_moment(v, like: torch.Tensor) -> bool:
    return torch.is_tensor(v) and tuple(v.shape) == tuple(like.shape) \
        and v.dim() > 0


def place(saved: dict, state: dict, placements: dict, mesh) -> None:
    """Load a layout-free checkpoint into ``state`` in place: each rank
    copies its shards of the whole tensors into its parameters, buffers
    and optimizer moments."""
    model, opt = state["model"], state["opt"]
    params = dict(sharding.placed_params(model))
    buffers = dict(model.named_buffers())
    whole = saved["model"]
    if set(whole) != set(params) | set(buffers):
        missing = sorted((set(params) | set(buffers)) - set(whole))
        extra = sorted(set(whole) - set(params) - set(buffers))
        raise ValueError(f"checkpoint does not match the model: missing "
                         f"{missing}, unexpected {extra}")

    def mine(name, x):
        return sharding.shard_tensor(x, placements.get(name, ()), mesh)

    with torch.no_grad():
        for name, p in params.items():
            p.copy_(mine(name, whole[name]))
        for name, b in buffers.items():
            b.copy_(whole[name])
    names = _opt_names(opt, params)
    index = {name: i for i, name in enumerate(names)}
    cur_groups = opt.state_dict()["param_groups"]
    saved_groups = saved["opt"]["param_groups"]
    if [sorted(names[i] for i in g["params"]) for g in cur_groups] != [
            g["params"] for g in saved_groups]:
        raise ValueError("checkpoint's optimizer param groups do not match "
                         "the optimizer's")
    groups = [{**{k: v for k, v in sg.items() if k != "params"},
               "params": g["params"]}
              for g, sg in zip(cur_groups, saved_groups)]
    moments = {
        index[name]: {k: mine(name, v) if _is_moment(v, whole[name]) else v
                      for k, v in st.items()}
        for name, st in saved["opt"]["state"].items()}
    opt.load_state_dict({"state": moments, "param_groups": groups})
    state["step"] = saved["step"]


class WorkloadCheckpointer:
    """Save and restore a trainer state ``{"step", "model", "opt"}`` (the
    port's ``LMTrainer``, ``Trainer`` and ``ViTTrainer`` states) under
    ``directory``, keeping the newest ``max_to_keep`` (at least 1).
    ``mesh`` and ``placements`` are the trainer's (its ``mesh`` and
    ``placements`` after ``init_state``): how this process's state is
    sharded. Under a mesh every rank calls ``save`` and ``restore``, and
    every rank must see the directory (one host, or a shared file
    system): each reads the file, and each decides from its listing
    whether to resume."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None,
                 placements: dict | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh, self.placements = mesh, placements or {}
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
        the same step), then drop all but the newest ``max_to_keep``.
        Every rank gathers; rank 0 writes; all return after it has."""
        saved = layout_free(step, state, self.placements, self.mesh)
        if not dist.is_initialized() or dist.get_rank() == 0:
            self._write(step, saved)
        if dist.is_initialized():
            dist.barrier()

    def _write(self, step: int, saved: dict) -> None:
        if not self._swept:
            for name in os.listdir(self.directory):
                if _TMP.match(name):
                    os.remove(os.path.join(self.directory, name))
            self._swept = True
        final = self.path(step)
        tmp = os.path.join(self.directory,
                           f".step_{int(step)}.pt.tmp{os.getpid()}")
        with open(tmp, "wb") as f:
            torch.save(saved, f)
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

    def _load(self, step: int | None) -> dict:
        """The saved dict of ``step``, mapped on the host; for ``None`` the
        newest that can be read, warning of each newer one that cannot."""
        def load(at):
            return torch.load(self.path(at), map_location="cpu",
                              weights_only=True, mmap=True)

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
        read) into ``state`` in place, each rank its own shards on the
        device of its model, and return it. Raises
        ``FileNotFoundError`` when the directory holds none."""
        saved = self._load(step)
        if saved.get("format") == FORMAT:
            place(saved, state, self.placements, self.mesh)
            return state
        if any(a is not None for dims in self.placements.values()
               for a in dims):
            raise ValueError(f"{self.directory}: a checkpoint of the "
                             f"one-device format restores only where every "
                             f"parameter is whole, not under fsdp or tp "
                             f"splits")
        state["model"].load_state_dict(saved["model"])
        state["opt"].load_state_dict(saved["opt"])
        state["step"] = saved["step"]
        return state

    def restore_model(self, model: torch.nn.Module,
                      step: int | None = None) -> int:
        """Load only the model's weights of ``step`` (default the latest
        that can be read) into ``model``, a whole one-device model, in
        place and return the step. The file is mapped on the host, so the
        optimizer's state never reaches the model's device."""
        saved = self._load(step)
        model.load_state_dict(saved["model"])
        return saved["step"]

    def close(self) -> None:
        """Nothing is left pending: every save is complete on return."""
