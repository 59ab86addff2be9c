"""The port's ``smoke``, ``mnist``, ``llm``, ``resnet50``, ``vit`` and
``serve`` job entry points on the CPU at a tiny size: the training jobs
emit loss lines (and the llm job its sampled tokens) and a done record,
checkpoint and resume (a resumed run ends on the bits of an uninterrupted
one), the llm job serves ``/metrics``, the serve job answers over HTTP
with both engines and from a checkpoint, and each takes the flags of the
reference's job, every one of which is ported now (the cases of
``test_unported_flags_raise`` and ``test_serve_unported_flags_raise``)."""

import contextlib
import http.server
import json
import re
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.telemetry.metrics import REGISTRY
from kubeoperator_tpu_torch.train import jobs
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads import train as ttrain

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--d-model", "32", "--heads", "4", "--layers", "2",
        "--d-ff", "64", "--seq-len", "16", "--vocab", "64", "--batch", "2"]


VIT_TINY = ["--device", "cpu", "--batch-per-chip", "2", "--image-size", "32",
            "--patch", "8", "--d-model", "32", "--heads", "4", "--layers",
            "2", "--classes", "10"]


RESNET_TINY = ["--device", "cpu", "--batch-per-chip", "2", "--image-size",
               "32", "--depth", "18"]


def run(capsys, *argv, cmd="llm"):
    flags = {"llm": TINY, "vit": VIT_TINY, "resnet50": RESNET_TINY}[cmd]
    assert jobs.main([cmd, *flags, *argv]) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def metrics_servers(monkeypatch):
    """Collects the servers ``maybe_start_metrics_server`` starts, and
    shuts them down on exit."""
    started = []
    start = jobs.maybe_start_metrics_server

    def keep(port):
        server = start(port)
        if server is not None:
            started.append(server)
        return server

    monkeypatch.setattr(jobs, "maybe_start_metrics_server", keep)
    try:
        yield started
    finally:
        for server in started:
            server.shutdown()
            server.server_close()


def test_smoke_reports_ok(capsys):
    """The reference's smoke job in one process: a 256×256 bf16 matmul of
    ones sums to 256³ and the psum over a world of one rank is 1; the
    record has the reference's keys."""
    assert jobs.main(["smoke", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec == {"job": "smoke", "devices": 1, "device_kind": "cpu",
                   "platform": "cpu", "matmul_sum": 16_777_216.0,
                   "psum": 1.0, "process_id": 0, "num_processes": 1,
                   "ok": True}


def test_smoke_over_several_cards_needs_the_multi_device_slice(monkeypatch,
                                                              capsys):
    """The multi-device slice runs the psum half: a process is one rank,
    however many cards it sees, and the ranks over several cards come from
    ``torchrun`` (tests/test_torch_dist_jobs.py runs two)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("RANK", raising=False)
    assert jobs.main(["smoke", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert (rec["devices"], rec["psum"], rec["ok"]) == (1, 1.0, True)


def test_mnist_improves(capsys):
    """``mnist --steps 6 --batch 16`` on the CPU: the last loss is below
    the first, as tests/test_jobs.py checks the JAX job."""
    assert jobs.main(["mnist", "--device", "cpu", "--steps", "6",
                      "--batch", "16"]) == 0
    records = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in records if "loss" in r] == list(range(6))
    done = records[-1]
    assert done["job"] == "mnist" and done["done"] and done["steps"] == 6
    assert done["improved"] and done["last_loss"] < done["first_loss"]


def test_mnist_exits_1_unless_the_loss_fell(monkeypatch, capsys):
    monkeypatch.setattr(ttrain.Trainer, "train_step",
                        lambda self, state, x, y: (
                            state, {"loss": torch.tensor(2.0)}))
    assert jobs.main(["mnist", "--device", "cpu", "--steps", "2",
                      "--batch", "2"]) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "improved"] is False


def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_serves_the_process_registry():
    """``/metrics`` answers 200 with the registry's text (the ko_train_*
    and ko_serve_* vocabularies declared from boot), any other path 404;
    port 0 starts nothing."""
    assert jobs.maybe_start_metrics_server(0) is None
    port = free_port()
    server = jobs.maybe_start_metrics_server(port)
    try:
        status, text = http_get(f"http://127.0.0.1:{port}/metrics")
        assert status == 200 and text == REGISTRY.render()
        assert "# TYPE ko_train_step_seconds histogram" in text
        assert "# TYPE ko_serve_requests_total counter" in text
        assert http_get(f"http://127.0.0.1:{port}/nope")[0] == 404
    finally:
        server.shutdown()
        server.server_close()


def test_llm_trains_and_samples(capsys):
    records = run(capsys, "--steps", "3", "--sample", "5")
    losses = [r["loss"] for r in records if "loss" in r]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3]
    assert all(loss == loss and loss > 0 for loss in losses)
    sampled = next(r["sampled_tokens"] for r in records if "sampled_tokens" in r)
    assert len(sampled) == 4 + 5 and all(0 <= t < 64 for t in sampled)
    done = records[-1]
    assert done["done"] and done["steps"] == 3 and done["device"] == "cpu"


def test_llm_f32_without_sampling(capsys):
    records = run(capsys, "--steps", "1", "--no-bf16")
    assert not any("sampled_tokens" in r for r in records)
    assert records[-1]["done"]


@pytest.mark.parametrize("flag,value", [
    ("--mesh", "dp:2"), ("--experts", "4"), ("--sp-attention", "ulysses"),
    ("--ckpt-dir", "ckpt"), ("--metrics-port", "8080")])
def test_unported_flags_raise(flag, value, monkeypatch, capsys, tmp_path):
    """Each flag of a part not ported yet raises, naming the ROADMAP.
    ``--experts``, ``--ckpt-dir``, ``--metrics-port``, ``--mesh`` and
    ``--sp-attention`` are ported: their cases show the job trains an MoE
    config of that many experts, writes a checkpoint that a rerun resumes
    from (under ``tmp_path``), serves ``/metrics`` while it trains (on a
    free port), takes a mesh of this process's one device (and refuses
    ``dp:2`` here, a world of one, as build_mesh does), and takes Ulysses
    (a no-op without an sp axis; the meshed job runs in
    tests/test_torch_dist_jobs.py)."""
    if flag == "--mesh":
        records = run(capsys, "--steps", "1", flag, "dp:auto")
        assert records[-1]["mesh"]["dp"] == 1 and records[-1]["chips"] == 1
        with pytest.raises(ValueError, match="wants 2 devices, got 1"):
            jobs.main(["llm", *TINY, "--steps", "1", flag, value])
        return
    if flag == "--sp-attention":
        records = run(capsys, "--steps", "1", flag, value)
        assert records[-1]["done"] and records[-1]["steps"] == 1
        return
    if flag == "--ckpt-dir":
        ckpt = str(tmp_path / value)
        run(capsys, "--steps", "1", flag, ckpt)
        records = run(capsys, "--steps", "2", flag, ckpt)
        assert records[0] == {"job": "llm", "resumed_at": 1}
        assert records[-1]["steps"] == 2
        assert sorted(p.name for p in (tmp_path / value).iterdir()) == [
            "step_1.pt", "step_2.pt"]
        return
    if flag == "--metrics-port":
        port = free_port()
        seen = []
        step = tlm.LMTrainer.train_step

        def scrape(self, state, tokens):
            seen.append(http_get(f"http://127.0.0.1:{port}/metrics"))
            return step(self, state, tokens)

        monkeypatch.setattr(tlm.LMTrainer, "train_step", scrape)
        with metrics_servers(monkeypatch) as started:
            records = run(capsys, "--steps", "1", flag, str(port))
            assert len(started) == 1 and started[0].server_address[1] == port
        assert records[-1]["done"] and seen[0][0] == 200
        assert "# TYPE ko_train_step_seconds histogram" in seen[0][1]
        return
    if flag != "--experts":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            jobs.main(["llm", *TINY, "--steps", "1", flag, value])
        return
    seen = []
    init = tlm.LMTrainer.__init__

    def spy(self, cfg, *a, **k):
        seen.append(cfg)
        init(self, cfg, *a, **k)

    monkeypatch.setattr(tlm.LMTrainer, "__init__", spy)
    records = run(capsys, "--steps", "1", flag, value)
    assert seen[0].moe_experts == 4 and records[-1]["done"]


def test_llm_moe_trains_and_samples(capsys):
    """``llm --experts 4 --sample 4``: finite losses, which include the
    aux, and sampled tokens from the trained MoE model."""
    records = run(capsys, "--steps", "2", "--experts", "4", "--sample", "4")
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(x) and x > 0 for x in losses)
    sampled = next(r["sampled_tokens"] for r in records if "sampled_tokens" in r)
    assert len(sampled) == 4 + 4 and all(0 <= t < 64 for t in sampled)
    assert records[-1]["done"] and records[-1]["steps"] == 2


def test_vit_trains_and_reports(capsys):
    records = run(capsys, "--steps", "5", cmd="vit")
    losses = [r["loss"] for r in records if "loss" in r]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(loss) and loss > 0 for loss in losses)
    done = records[-1]
    assert done["job"] == "vit" and done["done"] and done["steps"] == 5
    assert done["device"] == "cpu" and done["img_per_sec"] > 0


def test_vit_encoder_is_built_as_the_jax_job_builds_it(monkeypatch, capsys):
    """TransformerConfig defaults (auto attention, remat dots), d_ff 4·d,
    non-causal, seq (size/patch)²: at 16 patches auto is dense, so the
    job runs no flash op."""
    from kubeoperator_tpu_torch.workloads import vit as tvit
    seen = []
    init = tvit.ViTTrainer.__init__

    def spy(self, cfg, *a, **k):
        seen.append(cfg)
        init(self, cfg, *a, **k)

    monkeypatch.setattr(tvit.ViTTrainer, "__init__", spy)
    run(capsys, "--steps", "1", cmd="vit")
    enc = seen[0].encoder
    assert (enc.d_ff, enc.causal, enc.max_seq_len) == (128, False, 16)
    assert (enc.attention, enc.remat_policy, enc.flash_layout) == (
        "auto", "dots", "bh")
    assert (seen[0].num_classes, seen[0].image_size, seen[0].patch) == (
        10, 32, 8)


def test_vit_mesh_raises():
    """An axis the ViT gives no meaning raises, naming it (the meshed job
    runs in tests/test_torch_dist_jobs.py)."""
    with pytest.raises(NotImplementedError, match="mesh axis ep=2"):
        jobs.main(["vit", *VIT_TINY, "--steps", "1", "--mesh", "ep:2"])


def test_resnet50_trains_on_the_synthetic_stream(capsys):
    records = run(capsys, "--steps", "3", cmd="resnet50")
    losses = [r["loss"] for r in records if "loss" in r]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3]
    assert all(np.isfinite(loss) and loss > 0 for loss in losses)
    done = records[-1]
    assert done["job"] == "resnet50" and done["done"] and done["steps"] == 3
    assert done["device"] == "cpu" and done["img_per_sec"] > 0


def test_resnet50_reads_a_data_dir(capsys, tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "images.npy",
            rng.standard_normal((6, 32, 32, 3)).astype(np.float32))
    np.save(tmp_path / "labels.npy", rng.integers(0, 1000, 6).astype(np.int32))
    records = run(capsys, "--steps", "4", "--data-dir", str(tmp_path),
                  cmd="resnet50")          # 3 batches an epoch: a second epoch
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4]
    assert records[-1]["done"] and records[-1]["steps"] == 4


@pytest.mark.parametrize("size,stem", [(32, "conv"), (64, "space_to_depth"),
                                       (65, "conv")])
def test_resnet50_config_is_the_jax_job_s(monkeypatch, capsys, size, stem):
    """TrainConfig defaults (no K7/K8 modes), s2d stem for even sizes of
    at least 64, warmup min(100, steps), batch per chip on one chip."""
    seen = []
    init = ttrain.Trainer.__init__

    def spy(self, cfg, *a, **k):
        seen.append(cfg)
        init(self, cfg, *a, **k)

    monkeypatch.setattr(ttrain.Trainer, "__init__", spy)
    monkeypatch.setattr(ttrain.Trainer, "train_step",
                        lambda self, state, x, y: (
                            {**state, "step": state["step"] + 1},
                            {"loss": torch.tensor(1.0)}))
    assert jobs.main(["resnet50", "--device", "cpu", "--steps", "1",
                      "--batch-per-chip", "1", "--image-size", str(size),
                      "--depth", "18"]) == 0
    capsys.readouterr()
    cfg = seen[0]
    assert (cfg.stem, cfg.image_size, cfg.batch_size) == (stem, size, 1)
    assert (cfg.total_steps, cfg.warmup_steps, cfg.depth) == (1, 1, 18)
    assert (cfg.dw_dot_max_k, cfg.conv_bwd, cfg.fused_bn) == (0, "dot", False)


@pytest.mark.parametrize("flag,value", [("--mesh", "dp:2"),
                                        ("--ckpt-dir", "ckpt")])
def test_resnet50_unported_flags_raise(flag, value, capsys, tmp_path):
    """``--mesh dp:2`` in a world of one raises as ``build_mesh`` does, and
    an axis the ResNet gives no meaning raises, naming it (dp and fsdp run
    in tests/test_torch_dist_jobs.py). ``--ckpt-dir``
    is ported: the job checkpoints its last step under it (here
    ``tmp_path``), and a rerun resumes from it and continues the step
    count."""
    if flag == "--ckpt-dir":
        ckpt = str(tmp_path / value)
        run(capsys, "--steps", "1", flag, ckpt, cmd="resnet50")
        records = run(capsys, "--steps", "2", flag, ckpt, cmd="resnet50")
        assert records[0] == {"job": "resnet50", "resumed_at": 1}
        assert [r["step"] for r in records if "loss" in r] == [2]
        assert records[-1]["steps"] == 2
        return
    with pytest.raises(ValueError, match="wants 2 devices, got 1"):
        jobs.main(["resnet50", *RESNET_TINY, "--steps", "1", flag, value])
    with pytest.raises(NotImplementedError, match="mesh axis tp=2"):
        jobs.main(["resnet50", *RESNET_TINY, "--steps", "1", flag, "tp:2"])


class Preempted(Exception):
    """Stands for a pod killed between two steps."""


def exact_losses(monkeypatch, trainer_cls):
    """Record each step's loss as a float, bit for bit."""
    losses = []
    step = trainer_cls.train_step

    def spy(self, state, *batch):
        state, metrics = step(self, state, *batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    monkeypatch.setattr(trainer_cls, "train_step", spy)
    return losses


def final_state(path):
    return torch.load(path, weights_only=True)


def assert_same_bits(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same_bits(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, where


@pytest.mark.parametrize("cmd,data", [("llm", False), ("resnet50", False),
                                      ("resnet50", True)],
                         ids=["llm", "resnet50", "resnet50_npy"])
def test_resumed_run_ends_on_the_uninterrupted_bits(cmd, data, monkeypatch,
                                                    capsys, tmp_path):
    """A run preempted after step 2 (checkpoints every step) and restarted
    to 3 gives step 3 the loss of 3 uninterrupted steps and ends on the
    same model and optimizer bits, on the CPU. The resnet50 job's data
    stream continues too: synthetic from ``start=2``, an ``.npy`` dataset
    from ``skip_batches=2``. (The schedule's length is ``--steps``, so the
    preempted run is the 3-step run cut short, not a 2-step run.)"""
    trainer_cls = tlm.LMTrainer if cmd == "llm" else ttrain.Trainer
    extra = []
    if data:
        rng = np.random.default_rng(0)
        np.save(tmp_path / "images.npy",
                rng.standard_normal((5, 32, 32, 3)).astype(np.float32))
        np.save(tmp_path / "labels.npy",
                rng.integers(0, 1000, 5).astype(np.int32))
        extra = ["--data-dir", str(tmp_path)]
    losses = exact_losses(monkeypatch, trainer_cls)
    run(capsys, "--steps", "3", "--ckpt-dir", str(tmp_path / "whole"),
        *extra, cmd=cmd)
    whole = list(losses)
    assert len(whole) == 3

    spy = trainer_cls.train_step

    def preempted(self, state, *batch):
        if state["step"] == 2:
            raise Preempted
        return spy(self, state, *batch)

    cut = str(tmp_path / "cut")
    monkeypatch.setattr(trainer_cls, "train_step", preempted)
    with pytest.raises(Preempted):
        jobs.main([cmd, *{"llm": TINY, "resnet50": RESNET_TINY}[cmd],
                   "--steps", "3", "--ckpt-dir", cut, "--ckpt-every", "1",
                   *extra])
    capsys.readouterr()
    monkeypatch.setattr(trainer_cls, "train_step", spy)
    del losses[:]
    records = run(capsys, "--steps", "3", "--ckpt-dir", cut, *extra, cmd=cmd)
    assert records[0] == {"job": cmd, "resumed_at": 2}
    assert losses == whole[2:]
    assert records[-1]["steps"] == 3
    assert_same_bits(final_state(tmp_path / "whole" / "step_3.pt"),
                     final_state(tmp_path / "cut" / "step_3.pt"))


SERVE_TINY = ["--device", "cpu", "--vocab", "64", "--d-model", "32",
              "--heads", "4", "--layers", "2", "--d-ff", "64",
              "--max-seq-len", "32", "--no-bf16", "--host", "127.0.0.1",
              "--port", "0"]
HTTP_WAIT = 120.0     # seconds one HTTP exchange or join may take here


def series(text: str) -> dict[str, float]:
    """The samples of a Prometheus text exposition, by series."""
    return {k: float(v) for k, v in re.findall(r"^([^#\s]\S*) (\S+)$",
                                               text, re.M)}


class Counted:
    """The serve job's stats live on the process ``REGISTRY``, which every
    server of this process shares: counts are read as deltas from the
    moment the server was built."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.snapshot = batcher.stats.snapshot()
        self.series = series(batcher.stats.prometheus())

    def stats(self, body: str) -> dict:
        """A ``/stats`` reply with each count taken since the build."""
        now = json.loads(body)
        return {k: v - self.snapshot[k] if k.endswith("_total") else v
                for k, v in now.items()}

    def metrics(self, text: str) -> dict:
        """A ``/metrics`` reply's series, counters taken since the build."""
        return {k: v - self.series.get(k, 0.0)
                if k.split("{")[0].endswith("_total") else v
                for k, v in series(text).items()}


@contextlib.contextmanager
def serving(*argv):
    """The serve job's server on a free port, serving from a thread."""
    args = jobs.build_parser().parse_args(["serve", *SERVE_TINY, *argv])
    server, batcher = jobs.build_server(args)
    batcher.counted = Counted(batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", batcher
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=HTTP_WAIT)
        assert not thread.is_alive()


def call(url, body=None):
    """(status, body) of one GET, or of one POST when ``body`` is given
    (bytes are sent as they are, anything else as JSON)."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_WAIT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("engine", ["continuous", "dynamic"])
def test_serve_answers_over_http(capsys, engine):
    with serving("--engine", engine) as (url, batcher):
        status, body = call(url + "/healthz")
        assert status == 200 and json.loads(body)["model"] == {
            "d_model": 32, "layers": 2, "vocab": 64, "max_seq_len": 32}
        prompts = [[1, 2, 3], [5, 6, 7, 8, 9], [4], [10, 11, 12, 13]]
        got = {}

        def client(i):
            got[i] = call(url + "/generate", {"prompt_ids": prompts[i],
                                              "max_tokens": 6})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_WAIT)
            assert not t.is_alive()
        for i, prompt in enumerate(prompts):
            status, body = got[i]
            assert status == 200, body
            reply = json.loads(body)
            assert reply["tokens"][:len(prompt)] == prompt
            assert len(reply["new_tokens"]) == 6
            assert reply["tokens"][len(prompt):] == reply["new_tokens"]
            assert all(0 <= t < 64 for t in reply["new_tokens"])
            # greedy decoding repeats, whatever the request shared a batch
            # or the pool with
            again = call(url + "/generate", {"prompt_ids": prompt,
                                             "max_tokens": 6})
            assert again == (200, body)
        for bad in ({"max_tokens": 3}, {"prompt_ids": [1], "max_tokens": "x"},
                    {"prompt_ids": [1, 99]}, {"prompt_ids": []},
                    {"prompt_ids": [1] * 30, "max_tokens": 8}, b"not json"):
            status, body = call(url + "/generate", bad)
            assert status == 400 and "error" in json.loads(body), bad
        assert call(url + "/nowhere")[0] == 404
        assert call(url + "/nowhere", {})[0] == 404
        status, body = call(url + "/stats")
        stats = batcher.counted.stats(body)
        assert status == 200 and stats["requests_total"] == 8
        assert stats["tokens_generated_total"] == 48
        status, text = call(url + "/metrics")
        assert status == 200
        assert batcher.counted.metrics(text)["ko_serve_requests_total"] == 8
        assert "# TYPE ko_serve_ttft_seconds histogram" in text
        assert stats["errors_total"] == 0
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert records[0]["device"] == "cpu"
    assert records[1]["engine"] == engine


def test_serve_job_listens_until_interrupted(monkeypatch, capsys):
    def interrupted(self, *a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever",
                        interrupted)
    assert jobs.main(["serve", *SERVE_TINY, "--engine", "continuous",
                      "--slots", "2", "--segment", "4", "--page", "8"]) == 0
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    pool = next(r for r in records if r.get("engine") == "continuous")
    assert (pool["slots"], pool["segment"], pool["page"], pool["pages"]) == (
        2, 4, 8, 2 * 4 + 1)
    assert records[-1]["listening"].startswith("127.0.0.1:")


def test_serve_warms_dynamic_buckets(capsys):
    with serving("--warm", "3x5x6,1x9x2"):
        pass
    warmed = [json.loads(line).get("warming")
              for line in capsys.readouterr().out.splitlines()]
    assert [w for w in warmed if w] == ["4x8x8 prefill=4", "1x16x2 prefill=8"]


# what build_server's engine reports for each ported serve flag: (kv_dtype,
# spill_pages, spec_k, draft_layers, moe)
SERVE_PORTED = {"--kv-dtype": ("int8", 0, 0, 0, 0),
                "--spill-pages": ("bf16", 4, 0, 0, 0),
                "--spec-k": ("bf16", 0, 2, 1, 0),
                "--moe": ("bf16", 0, 0, 0, 4)}


@pytest.mark.parametrize("flag,value", [
    ("--mesh", "dp:2"), ("--ckpt-dir", "ckpt"), ("--kv-dtype", "int8"),
    ("--spill-pages", "4"), ("--spec-k", "2"), ("--draft-layers", "1"),
    ("--moe", "4"), ("--aot-cache", "aot")])
def test_serve_unported_flags_raise(flag, value, capsys, tmp_path):
    """Each flag of a part not ported yet raises, naming the ROADMAP.
    ``--ckpt-dir``, ``--kv-dtype``, ``--spill-pages``, ``--spec-k``,
    ``--draft-layers``, ``--moe``, ``--mesh`` and ``--aot-cache`` are
    ported: their cases show the parser takes them and ``build_server``
    builds an engine with them (``--spec-k`` beside ``--draft-layers 1``;
    ``--ckpt-dir`` on an empty directory under ``tmp_path`` serves fresh
    weights and says so; ``--aot-cache`` consults the compile cache in a
    directory under ``tmp_path`` and the engine's record carries the
    reference's ``aot`` record, a consult that builds and writes nothing,
    since the pool launches no kernel library); ``--draft-layers`` alone
    reaches the engine's validation, which needs ``--spec-k``; ``--mesh
    dp:2`` outside ``torchrun`` is a world of one, which the engine
    refuses naming the count (the meshed job runs in
    tests/test_torch_serve_mesh.py)."""
    argv = ["serve", *SERVE_TINY, "--engine", "continuous", flag, value]
    if flag == "--aot-cache":
        argv[-1] = str(tmp_path / value)
        server, batcher = jobs.build_server(
            jobs.build_parser().parse_args(argv))
        server.server_close()
        pool = next(json.loads(line) for line in
                    capsys.readouterr().out.splitlines()
                    if json.loads(line).get("engine") == "continuous")
        assert pool["aot"] == {"hit": True, "fingerprint": "none",
                               "seconds": 0.0}
        assert batcher.engine.aot.source == "none"
        assert list((tmp_path / value).iterdir()) == []
        return
    if flag == "--mesh":
        with pytest.raises(SystemExit, match="wants 2 devices, got 1"):
            jobs.main(argv)
        return
    if flag == "--ckpt-dir":
        argv[-1] = str(tmp_path / value)
        server, batcher = jobs.build_server(
            jobs.build_parser().parse_args(argv))
        server.server_close()
        records = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert records[0]["weights"] == "fresh-init (no checkpoint)"
        assert batcher.engine.slots == 16
        return
    if flag == "--draft-layers":
        with pytest.raises(SystemExit, match="requires spec_k"):
            jobs.main(argv)
        return
    if flag == "--spec-k":
        argv += ["--draft-layers", "1"]
    server, batcher = jobs.build_server(jobs.build_parser().parse_args(argv))
    server.server_close()
    eng = batcher.engine
    got = (eng.kv_dtype, eng.spill_pages, eng.spec_k, eng.draft_layers,
           eng.cfg.moe_experts)
    assert got == SERVE_PORTED[flag]
    pool = next(json.loads(line) for line in
                capsys.readouterr().out.splitlines()
                if json.loads(line).get("engine") == "continuous")
    assert (pool["kv_dtype"], pool["spill_pages"], pool["spec_k"],
            pool["draft_layers"], pool["moe"]) == got


@pytest.mark.parametrize("flags", [["--spec-k", "2", "--draft-layers", "1"],
                                   ["--moe", "4"]], ids=["spec", "moe"])
def test_serve_spec_and_moe_engines_over_http(flags):
    """The continuous engine with speculation, and over an MoE model,
    answers /generate (greedy replies repeat) and its /metrics carries the
    engine's families."""
    with serving("--engine", "continuous", *flags) as (url, batcher):
        prompt = [5, 9, 2, 6, 5, 3]
        first = call(url + "/generate", {"prompt_ids": prompt,
                                         "max_tokens": 6})
        assert first[0] == 200, first
        reply = json.loads(first[1])
        assert reply["tokens"][:len(prompt)] == prompt
        assert len(reply["new_tokens"]) == 6
        assert call(url + "/generate", {"prompt_ids": prompt,
                                        "max_tokens": 6}) == first
        sampled = call(url + "/generate", {"prompt_ids": [1, 2, 3],
                                           "max_tokens": 5,
                                           "temperature": 0.8, "seed": 4})
        assert sampled[0] == 200 and len(json.loads(sampled[1])[
            "new_tokens"]) == 5
        status, text = call(url + "/metrics")
        got = batcher.counted.metrics(text)
        assert status == 200 and got["ko_serve_requests_total"] == 3
        if "--moe" in flags:
            assert 'ko_serve_moe_expert_load{expert="3"}' in text
        else:
            assert batcher.engine.spec_draft_tokens > 0
            assert got["ko_serve_spec_draft_tokens_total"] == (
                batcher.engine.spec_draft_tokens)


def test_serve_quantized_spill_engine_over_http(capsys):
    """The continuous engine with int8 pages and a spill tier answers over
    HTTP: the prompt echoed, the asked length, repeats equal (the second
    is a full prefix hit), and /stats counts the hit."""
    with serving("--engine", "continuous", "--page", "4", "--kv-dtype",
                 "int8", "--spill-pages", "8") as (url, batcher):
        prompt = [5, 9, 2, 6, 5, 3, 5, 8]
        first = call(url + "/generate", {"prompt_ids": prompt,
                                         "max_tokens": 6})
        again = call(url + "/generate", {"prompt_ids": prompt,
                                         "max_tokens": 6})
        assert first[0] == 200 and again == first
        reply = json.loads(first[1])
        assert reply["tokens"][:len(prompt)] == prompt
        assert len(reply["new_tokens"]) == 6
        status, body = call(url + "/stats")
        stats = batcher.counted.stats(body)
        assert status == 200 and stats["requests_total"] == 2
        assert stats["prefix_hits_total"] == 1
        assert stats["kv_spill_pages"] == 0
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    pool = next(r for r in records if r.get("engine") == "continuous")
    assert (pool["kv_dtype"], pool["spill_pages"], pool["page"]) == (
        "int8", 8, 4)


@pytest.mark.parametrize("spec", ["8x128", "abc", "3x5x6,", "2x0x4"])
def test_serve_refuses_a_bad_warm_spec(spec, capsys):
    """A ``--warm`` element that is not three positive integers exits
    naming the element and the BxPxN form (the reference raises a bare
    ValueError from its unpacking). The good spec of
    test_serve_warms_dynamic_buckets still warms 4x8x8 prefill=4."""
    bad = spec.split(",")[-1] if spec.endswith(",") else spec
    with pytest.raises(SystemExit, match=rf"{re.escape(repr(bad))} is not "
                                         rf"BxPxN"):
        with serving("--warm", spec):
            pass
    assert jobs.parse_warm(" 3 x 5 x 6") == (3, 5, 6)


@pytest.mark.parametrize("engine", ["continuous", "dynamic"])
def test_serve_stats_are_on_the_process_registry(engine):
    """As in the reference, the serve job's batcher records into the
    process ``REGISTRY``, so the llm job's ``/metrics`` server and the
    serve job's ``/metrics`` read one registry."""
    with serving("--engine", engine) as (url, batcher):
        assert batcher.stats.registry is REGISTRY
        assert call(url + "/generate", {"prompt_ids": [1, 2],
                                        "max_tokens": 2})[0] == 200
        text = call(url + "/metrics")[1]
        assert "# TYPE ko_train_step_seconds histogram" in text
        assert batcher.counted.metrics(text)["ko_serve_requests_total"] == 1


def test_serve_traces_each_request_into_the_process_ring(monkeypatch):
    """As the reference's serve job does, the continuous engine's batcher
    carries a ``ServeTracer`` writing to ``SERVE_TRACES``, its span cap
    the reference's ``trace_max_spans`` (4,000; ``KO_TRACE_MAX_SPANS``
    overrides it): a reply leaves a complete tree under its request."""
    from kubeoperator_tpu_torch.telemetry.serve_trace import SERVE_TRACES

    monkeypatch.setenv("KO_TRACE_MAX_SPANS", "64")
    with serving("--engine", "continuous") as (url, batcher):
        assert batcher._tracer.max_spans == 64
        assert batcher._tracer.store is SERVE_TRACES
        before = {r.name for r in SERVE_TRACES.records()}
        assert call(url + "/generate", {"prompt_ids": [1, 2, 3],
                                        "max_tokens": 4})[0] == 200
        new = [r for r in SERVE_TRACES.records() if r.name not in before]
        assert len(new) == 1 and new[0].dropped == 0
        assert {"request", "enqueue", "admit", "prefill", "segment",
                "retire"} <= {sp["name"] for sp in new[0].spans}
    monkeypatch.delenv("KO_TRACE_MAX_SPANS")
    with serving("--engine", "continuous") as (url, batcher):
        assert batcher._tracer.max_spans == 4000


def test_serve_answers_from_the_llm_jobs_checkpoint(capsys, tmp_path):
    """``serve --ckpt-dir`` over the llm job's checkpoint (2 steps at the
    serve widths): it announces the checkpoint's step, and a greedy
    ``/generate`` equals ``generate()`` on the checkpoint's model, token
    for token, and differs from the fresh weights' reply."""
    from kubeoperator_tpu_torch.workloads.checkpoint import (
        WorkloadCheckpointer,
    )
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.transformer import (
        TransformerConfig,
    )

    ckpt = str(tmp_path / "ckpt")
    assert jobs.main(["llm", *TINY, "--no-bf16", "--steps", "2",
                      "--ckpt-dir", ckpt]) == 0
    capsys.readouterr()
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_seq_len=32, dtype=torch.float32)
    state = WorkloadCheckpointer(ckpt).restore(
        tlm.LMTrainer(cfg, device="cpu").init_state())
    prompt = [5, 9, 2, 6, 5, 3]
    want = generate(cfg, state["model"].eval(), [prompt], 8,
                    device="cpu")[0].tolist()
    replies = {}
    for label, flags in (("checkpoint", ["--ckpt-dir", ckpt]), ("fresh", [])):
        with serving(*flags) as (url, _):
            status, body = call(url + "/generate", {"prompt_ids": prompt,
                                                    "max_tokens": 8})
            assert status == 200, body
            replies[label] = json.loads(body)["tokens"]
        records = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert records[0]["weights"] == (
            "checkpoint step 2" if flags else "fresh-init (no checkpoint)")
    assert replies["checkpoint"] == want
    assert replies["fresh"] != want
