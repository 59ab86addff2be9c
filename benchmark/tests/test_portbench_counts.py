"""The frozen counts: forward FLOPs against hand counts and the port's own
functions, and the kernel layers' bounds against the numbers the port's
chip runs state (PERF.md's kernel table, ``chip_smoke.py``'s bounds)."""

import pytest
import torch

from benchmark.configs import resnet50, vit_b16
from benchmark.harness import peaks, spec

torch.set_num_threads(2)

H100 = peaks.peaks_for("NVIDIA H100 80GB HBM3")


def config(name):
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def test_resnet50_forward_flops():
    got = resnet50.flops_per_image(config("resnet50"))
    # by hand: stem 2·192·64·112² = 0.308 G, the blocks' convs 7.63 G, the
    # projections 0.31 G, the head 4 M: 8.25 GFLOP a 224² image
    assert got == pytest.approx(8.25e9, rel=5e-3)
    from kubeoperator_tpu_torch.workloads import resnet
    assert got == resnet.flops_per_image(50, 224, 1000,
                                         stem="space_to_depth")


def test_vit_b16_forward_flops():
    got = vit_b16.flops_per_image(config("vit_b16"))
    # by hand: 196·12·(2·4·768² + 2·3·768·3072 + 4·196·768) plus the patch
    # embedding (0.231 G) and the head: 46.0 GFLOP
    hand = (196 * 12 * (2 * 4 * 768 ** 2 + 2 * 3 * 768 * 3072
                        + 4 * 196 * 768) + 2 * 768 * 768 * 196
            + 2 * 768 * 1000)
    assert got == hand == pytest.approx(46.0e9, rel=5e-3)
    from kubeoperator_tpu_torch.workloads import vit
    assert got == vit.flops_per_image(vit.ViTConfig())


def ms(flops, nbytes, rate=H100[0]):
    return peaks.bound_s(flops, nbytes, rate, H100[1]) * 1e3


def test_attention_bounds_at_vits_shape():
    # at B 128, H 12, T 196 (→ 256), D 64 the op's forward is K4's work:
    # 0.046 ms by its bytes (PERF.md's kernel table); its backward reads
    # Q, K, V, O, dO once and writes dQ, dK, dV, 8 blocks and a row: 0.092
    # ms, against 0.151 for K5, K6 and Δ counted one by one
    blk, row = 128 * 12 * 196 * 64 * 2, 128 * 12 * 196 * 4
    (f_fwd, b_fwd), (f_bwd, b_bwd) = vit_b16.attention_work(
        128 * 12, 196, 64)
    assert (b_fwd, b_bwd) == (4 * blk + row, 8 * blk + row)
    assert f_bwd == 2.5 * f_fwd == 2.5 * 4 * 196 ** 2 * 64 * 128 * 12
    assert [round(ms(f_fwd, b_fwd), 3), round(ms(f_bwd, b_bwd), 3)] == \
        [0.046, 0.092]


def test_conv_bounds_are_chip_smokes():
    import chip_smoke
    for n, ci, co in ((25088, 256, 1024), (100352, 512, 128)):
        want = chip_smoke.conv_bounds(n, ci, co, *H100)["K7"]
        assert resnet50.site_work(("k7", n, ci, co)) == (want["flops"],
                                                         want["bytes"])
    n, ci, co, _ = chip_smoke.K8_PATH
    want = chip_smoke.conv_bounds(n, ci, co, *H100)["K8"]
    assert resnet50.site_work(("k8", n, ci, co)) == (want["flops"],
                                                     want["bytes"])
    # K7 at 25,088 rows 256→1024: dx 0.019 and dW 0.020 ms alone (bytes,
    # PERF.md), 0.0266 ms together (operations); K8 at 401,408 rows
    # 64→256: 0.1534 ms (bytes)
    assert ms(*resnet50.site_work(("k7", 25088, 256, 1024))) == \
        pytest.approx(0.02660, abs=5e-5)
    assert ms(*resnet50.site_work(("k8", 401408, 64, 256))) == \
        pytest.approx(0.15340, abs=5e-5)


def test_conv_bwd_sites_at_batch_128_are_the_ports():
    import chip_smoke
    sites = resnet50.conv_bwd_sites(config("resnet50"), 128)
    k7 = {}
    for s in sites:
        if s[0] == "k7":
            k7[s[1:]] = k7.get(s[1:], 0) + 1
    assert k7 == {(n, ci, co): k for n, ci, co, k in chip_smoke.K7_SITES}
    k8 = {}
    for s in sites:
        if s[0] == "k8":
            k8[s[1:]] = k8.get(s[1:], 0) + 1
    assert k8 == {(n, ci, co): k for n, ci, co, _, k in chip_smoke.K8_SITES}
    assert [s for s in sites if s[0] == "strided"] == [
        ("strided", 401408, 100352, 256, 512),
        ("strided", 100352, 25088, 512, 1024),
        ("strided", 25088, 6272, 1024, 2048)]


def test_layer_bounds_by_path():
    cfg = config("resnet50")
    k7k8 = resnet50.layer_bounds(cfg, {"path": "k7k8", "batch_per_chip": 256},
                                 *H100)
    assert set(k7k8) == {"conv_bwd"} and 0 < k7k8["conv_bwd"] < 0.05
    assert resnet50.layer_bounds(cfg, {"path": "job", "batch_per_chip": 256},
                                 *H100) == {}
    flash = vit_b16.layer_bounds(config("vit_b16"),
                                 {"path": "flash", "batch_per_chip": 128},
                                 *H100)
    # 12 layers of the op's forward and backward: 12 × 0.13875 ms
    assert flash["flash"] * 1e3 == pytest.approx(1.6651, rel=1e-4)
