"""The port's ``llm``, ``resnet50``, ``vit`` and ``serve`` job entry
points on the CPU at a tiny size: the training jobs emit loss lines (and
the llm job its sampled tokens) and a done record, the serve job answers
over HTTP with both engines, and each refuses the flags whose parts are
not ported yet."""

import contextlib
import http.server
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.train import jobs

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
def test_unported_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jobs.main(["llm", *TINY, "--steps", "1", flag, value])


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jobs.main(["vit", *VIT_TINY, "--steps", "1", "--mesh", "dp:2"])


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
    from kubeoperator_tpu_torch.workloads import train as ttrain
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
def test_resnet50_unported_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jobs.main(["resnet50", *RESNET_TINY, "--steps", "1", flag, value])


SERVE_TINY = ["--device", "cpu", "--vocab", "64", "--d-model", "32",
              "--heads", "4", "--layers", "2", "--d-ff", "64",
              "--max-seq-len", "32", "--no-bf16", "--host", "127.0.0.1",
              "--port", "0"]
HTTP_WAIT = 120.0     # seconds one HTTP exchange or join may take here


@contextlib.contextmanager
def serving(*argv):
    """The serve job's server on a free port, serving from a thread."""
    args = jobs.build_parser().parse_args(["serve", *SERVE_TINY, *argv])
    server, batcher = jobs.build_server(args)
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
        stats = json.loads(body)
        assert status == 200 and stats["requests_total"] == 8
        assert stats["tokens_generated_total"] == 48
        status, text = call(url + "/metrics")
        assert status == 200
        assert "ko_serve_requests_total 8" in text
        assert "# TYPE ko_serve_ttft_seconds histogram" in text
        assert batcher.stats.snapshot()["errors_total"] == 0
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


@pytest.mark.parametrize("flag,value", [
    ("--mesh", "dp:2"), ("--ckpt-dir", "ckpt"), ("--kv-dtype", "int8"),
    ("--spill-pages", "4"), ("--spec-k", "2"), ("--draft-layers", "1"),
    ("--moe", "4"), ("--aot-cache", "aot")])
def test_serve_unported_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jobs.main(["serve", *SERVE_TINY, "--engine", "continuous", flag,
                   value])
