"""The step phases of the port's three trainers (``tracing.StepPhases``):
``ko_train_steps_total`` and the host seconds of each phase, the
``ko.train.*`` profiler ranges, the families' headers from boot, and the
device markers, which a step never waits for (a stand-in event on the
CPU; the real ones in the ``gpu`` test, which imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_train_phases.py

and skips without a card)."""

import pytest
import torch

from kubeoperator_tpu_torch.telemetry import tracing
from kubeoperator_tpu_torch.telemetry.metrics import (
    REGISTRY, Registry, declare_train_metrics,
)
from kubeoperator_tpu_torch.telemetry.tracing import StepPhases
from kubeoperator_tpu_torch.workloads.lm import LMTrainer
from kubeoperator_tpu_torch.workloads.train import TrainConfig, Trainer
from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig
from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer

torch.set_num_threads(2)

CHILDREN = ("forward", "backward", "optimizer", "metrics")
FAMILIES = ("ko_train_steps_total", "ko_train_phase_host_seconds_total",
            "ko_train_phase_device_seconds_total",
            "ko_train_phase_skipped_total")


def toy(kind: str, device="cpu"):
    """(trainer, state, batch) at a toy size."""
    if kind == "resnet50":
        tr = Trainer(TrainConfig(batch_size=2, image_size=32, depth=18,
                                 num_classes=10, stem="conv",
                                 dtype=torch.float32), device=device)
        batch = tr.synthetic_batch()
    elif kind == "vit":
        enc = TransformerConfig(d_model=32, n_heads=2, n_layers=1, d_ff=64,
                                causal=False, max_seq_len=16,
                                dtype=torch.float32)
        tr = ViTTrainer(ViTConfig(num_classes=10, image_size=32, patch=8,
                                  encoder=enc), device=device)
        batch = tr.synthetic_batch(2)
    else:
        tr = LMTrainer(TransformerConfig(vocab_size=64, d_model=32,
                                         n_heads=2, n_layers=1, d_ff=64,
                                         max_seq_len=16,
                                         dtype=torch.float32),
                       device=device)
        batch = (tr.synthetic_batch(2, 16),)
    return tr, tr.init_state(seed=0), batch


TRAINERS = ("resnet50", "vit", "llm")


@pytest.fixture(params=TRAINERS)
def fresh(request):
    """A toy trainer whose phases record on a registry of their own."""
    tr, state, batch = toy(request.param)
    reg = Registry()
    tr.phases = StepPhases(tr.phases.workload, tr.device, registry=reg)
    return tr, state, batch, declare_train_metrics(reg)


def host(fams, workload) -> dict:
    return {key[1]: v for key, v in fams["phase_host"].samples().items()
            if key[0] == workload}


def test_each_trainer_labels_its_phases_with_its_job():
    for kind in TRAINERS:
        assert toy(kind)[0].phases.workload == kind


JOBS = {   # steps, flags (the mnist job exits 1 unless its loss fell)
    "mnist": (6, ["--batch", "16"]),
    "resnet50": (2, ["--batch-per-chip", "2", "--image-size", "32",
                     "--depth", "18"]),
    "vit": (2, ["--batch-per-chip", "2", "--image-size", "32", "--patch",
                "8", "--d-model", "32", "--heads", "2", "--layers", "1",
                "--classes", "10"]),
    "llm": (2, ["--d-model", "32", "--heads", "2", "--layers", "1",
                "--d-ff", "64", "--seq-len", "16", "--vocab", "64",
                "--sample", "0"]),
}


@pytest.mark.parametrize("job", JOBS)
def test_each_job_counts_its_steps_under_its_name(job, capsys):
    """The job names its trainer's counters (the mnist job's ResNet too),
    and its mean step lands once in the reference's
    ``ko_train_step_seconds``, as the fsdp and pipeline jobs' do."""
    from kubeoperator_tpu_torch.train import jobs
    steps = REGISTRY.get("ko_train_steps_total")
    hist = REGISTRY.get("ko_train_step_seconds")
    before = steps.value(workload=job), hist.count(workload=job)
    n, flags = JOBS[job]
    assert jobs.main([job, "--device", "cpu", "--steps", str(n), *flags]) == 0
    capsys.readouterr()
    assert steps.value(workload=job) == before[0] + n
    assert hist.count(workload=job) == before[1] + 1
    assert hist.sum(workload=job) > 0


def test_mean_step_reads_the_counters(standin_cuda):
    reg = Registry()
    ph = StepPhases("w", "cpu", registry=reg)
    assert ph.mean_step_seconds() is None
    for _ in range(3):
        with ph.step():
            pass
    host = declare_train_metrics(reg)["phase_host"]
    assert ph.mean_step_seconds() == pytest.approx(
        host.value(workload="w", phase="step") / 3)
    card = StepPhases("c", "cuda", registry=reg)
    for _ in range(2):
        with card.step():
            with card.phase("forward"):
                pass
    StandIn.done = True
    card.flush()
    # two intervals of 1 ms a step: the step's own and the forward's
    assert card.mean_step_seconds() == pytest.approx(2e-3)


def test_one_step_counts_once_and_times_each_phase(fresh):
    tr, state, batch, fams = fresh
    w = tr.phases.workload
    tr.train_step(state, *batch)
    assert fams["steps"].value(workload=w) == 1
    spent = host(fams, w)
    assert set(spent) == {"step", *CHILDREN}        # no grad_reduce
    assert all(s > 0 for s in spent.values())
    tr.train_step(state, *batch)
    assert fams["steps"].value(workload=w) == 2


def test_children_fit_inside_the_step(fresh):
    tr, state, batch, fams = fresh
    for _ in range(2):
        tr.train_step(state, *batch)
    spent = host(fams, tr.phases.workload)
    assert sum(spent[c] for c in CHILDREN) <= spent["step"]


def test_no_device_samples_on_the_cpu(fresh):
    tr, state, batch, fams = fresh
    tr.train_step(state, *batch)
    tr.phases.flush()
    assert fams["phase_device"].samples() == {}
    assert fams["phase_skipped"].samples() == {}


def test_the_process_registry_counts_the_trainers_steps():
    tr, state, batch = toy("llm")
    steps = REGISTRY.get("ko_train_steps_total")
    before = steps.value(workload="llm")
    tr.train_step(state, *batch)
    assert steps.value(workload="llm") == before + 1


def spans(prof, prefix="ko.train."):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(prefix)]


@pytest.mark.parametrize("kind", TRAINERS)
def test_profiler_ranges_hold_the_steps_ops(kind):
    from torch.profiler import ProfilerActivity, profile
    tr, state, batch = toy(kind)
    tr.train_step(state, *batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(state, *batch)
    ranges = spans(prof)
    names = {n for n, _, _ in ranges}
    assert names == {f"ko.train.{p}" for p in ("step", *CHILDREN)}
    (_, s0, s1), = [r for r in ranges if r[0] == "ko.train.step"]
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    assert ops and all(s0 <= e.time_range.start and e.time_range.end <= s1
                       for e in ops)
    for phase in ("forward", "backward", "optimizer"):
        held = [e for e in ops for n, a, b in ranges
                if n == f"ko.train.{phase}"
                and a <= e.time_range.start and e.time_range.end <= b]
        assert held, phase
    # the children do not overlap: each step's time is split, not shared
    kids = sorted((a, b) for n, a, b in ranges if n != "ko.train.step")
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(kids, kids[1:]))


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    original = torch.autograd.profiler.record_function

    def refuse(name, *a, **k):
        if name.startswith(tracing.RANGE_PREFIX):
            raise AssertionError(f"range {name} entered with no profiler")
        return original(name, *a, **k)    # the optimizer's own ranges

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tr, state, batch = toy("resnet50")
    tr.train_step(state, *batch)


def test_the_families_render_from_boot():
    for reg in (REGISTRY, Registry()):
        declare_train_metrics(reg)
        text = reg.render()
        for name in FAMILIES:
            assert f"# HELP {name} " in text
            assert f"# TYPE {name} counter" in text


class StandIn:
    """A timing event whose card has passed it only once ``done`` is set;
    ``elapsed_time`` reads 1 ms between any two markers."""
    done = False
    reads = 0

    def record(self, stream=None):
        assert stream == "stream"

    def query(self):
        return StandIn.done

    def elapsed_time(self, other):
        if not (StandIn.done and other.query()):
            raise AssertionError("elapsed_time on an unfinished event")
        StandIn.reads += 1
        return 1.0


@pytest.fixture
def standin_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("train_step synchronized")

    monkeypatch.setattr(StandIn, "done", False)
    monkeypatch.setattr(StandIn, "reads", 0)
    monkeypatch.setattr(torch.cuda, "Event", lambda **k: StandIn())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


@pytest.mark.parametrize("kind", TRAINERS)
def test_markers_the_card_has_not_passed_never_block(kind, standin_cuda):
    tr, state, batch = toy(kind)
    reg = Registry()
    fams = declare_train_metrics(reg)
    # the trainer computes on the CPU; its markers go to stand-in events
    tr.phases = StepPhases(kind, "cuda", registry=reg)
    steps = 10
    for _ in range(steps):
        tr.train_step(state, *batch)
    assert StandIn.reads == 0
    assert fams["phase_device"].samples() == {}
    skipped = fams["phase_skipped"].value(workload=kind)
    marked = steps - skipped
    # a step takes 7 markers (its entry, each child's, the optimizer's
    # twice, and its end): 9 steps hold 63 of the 64, the 10th runs dry
    assert marked == 9
    assert fams["steps"].value(workload=kind) == steps
    StandIn.done = True
    tr.phases.flush()
    dev = {key[1]: v for key, v in fams["phase_device"].samples().items()}
    # 6 intervals of 1 ms a step tile it: 5 in the children (the
    # optimizer's two) and the step's own before the first child
    assert dev["step"] == pytest.approx(marked * 6e-3)
    assert dev["optimizer"] == pytest.approx(marked * 2e-3)
    assert sum(dev[c] for c in CHILDREN) == pytest.approx(marked * 5e-3)
    assert StandIn.reads == marked * 6
    # the pool is whole again: the next step marks
    tr.train_step(state, *batch)
    assert fams["phase_skipped"].value(workload=kind) == skipped


def test_a_step_with_more_markers_than_the_pool_drops_them(standin_cuda,
                                                          monkeypatch):
    monkeypatch.setattr(tracing, "EVENT_POOL", 4)
    reg = Registry()
    fams = declare_train_metrics(reg)
    ph = StepPhases("w", "cuda", registry=reg)
    with ph.step():
        for _ in range(4):
            with ph.phase("forward"):
                pass
    assert fams["phase_skipped"].value(workload="w") == 1
    assert fams["steps"].value(workload="w") == 1
    StandIn.done = True
    ph.flush()
    assert fams["phase_device"].samples() == {}
    with ph.step():
        with ph.phase("forward"):
            pass
    ph.flush()
    assert fams["phase_device"].value(workload="w", phase="step") > 0


@pytest.mark.gpu
def test_device_step_seconds_match_an_event_window_on_the_card():
    """Ten LM steps whose device work outlasts their host work: after a
    synchronize and ``flush()``, the device ``step`` seconds lie within 1%
    of one pair of events around the ten, and no step was skipped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this checks the device markers")
    cfg = TransformerConfig(vocab_size=32_000, d_model=1024, n_heads=8,
                            n_layers=4, d_ff=4096, max_seq_len=1024,
                            dtype=torch.bfloat16)
    tr = LMTrainer(cfg, device="cuda")
    reg = Registry()
    fams = declare_train_metrics(reg)
    tr.phases = StepPhases("llm", tr.device, registry=reg)
    state = tr.init_state(seed=0)
    tokens = tr.synthetic_batch(16, 1024)
    for _ in range(3):
        tr.train_step(state, tokens)
    torch.cuda.synchronize()
    tr.phases.flush()
    before = fams["phase_device"].value(workload="llm", phase="step")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        tr.train_step(state, tokens)
    end.record()
    torch.cuda.synchronize()
    tr.phases.flush()
    window = start.elapsed_time(end) / 1e3
    got = fams["phase_device"].value(workload="llm", phase="step") - before
    assert got == pytest.approx(window, rel=0.01)
    assert fams["phase_skipped"].value(workload="llm") == 0
    parts = sum(fams["phase_device"].value(workload="llm", phase=p)
                for p in CHILDREN)
    assert parts <= fams["phase_device"].value(workload="llm", phase="step")
