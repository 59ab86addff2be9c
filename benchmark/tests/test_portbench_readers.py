"""The trace reduction and every metric reader, on a made-up profile and
span list."""

import pytest

from benchmark.harness import spec, trace


def made_up() -> dict:
    """Two steps from t = 0 to 1,000 us, the sync ending at 1,000: kernels
    (us) and host ops; op 2 (a conv backward node) holds op 3 (its
    kernels' launch), which must not be counted twice."""
    device = [
        ["ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0, 100],
        ["void at::native::vectorized_elementwise_kernel<...>", 100, 300],
        ["sm90_xmma_gemm_bf16bf16_bf16f32", 300, 400],
        ["k7_wgmma_kernel<true>", 400, 450],
        ["void at::native::unrolled_elementwise_kernel<copy_kernel>", 450, 500],
        ["sm90_xmma_fprop_implicit_gemm", 700, 900],
        ["Memcpy DtoD (Device -> Device)", 900, 950],
        ["k8_dx_wgmma_kernel", 1200, 1300],        # after the stretch
    ]
    ops = [
        ["portbench.step", 0, 480, 500, -1],
        ["portbench.step", 480, 960, 350, -1],
        ["autograd::engine::evaluate_function: _ConvBackward", 390, 470, 100, 0],
        ["_ConvBackward", 395, 465, 100, 2],
        ["aten::add_", 500, 690, 0, 1],
        ["portbench.sync", 960, 1000, 0, -1],
        ["autograd::engine::evaluate_function: _ConvBackward", 1100, 1200,
         100, -1],                                  # after the stretch
    ]
    return {"device": device, "ops": ops}


@pytest.fixture
def summary():
    return trace.reduce(made_up(), {"conv_bwd": ("_ConvBackward",),
                                    "flash": ("flash_attention",)}, 2)


def test_reduce(summary):
    assert summary["window_s"] == pytest.approx(1000e-6)
    assert summary["busy_s"] == pytest.approx(750e-6)     # 0-500, 700-950
    cls = summary["class_s"]
    assert cls["nccl"] == pytest.approx(100e-6)
    assert cls["other elementwise/reduction"] == pytest.approx(200e-6)
    assert cls["casts and copies"] == pytest.approx(100e-6)
    assert cls["gemm (cuBLAS)"] == pytest.approx(100e-6)
    assert cls["conv (cuDNN)"] == pytest.approx(200e-6)
    assert cls["conv backward K7/K8 (port)"] == pytest.approx(50e-6)
    assert summary["op_device_s"] == {"conv_bwd": pytest.approx(100e-6),
                                      "flash": 0.0}
    gaps = summary["gaps"]
    assert gaps[0] == ["aten::add_", pytest.approx(200e-6)]
    assert gaps[1] == ["portbench.step", pytest.approx(50e-6)]
    assert summary["top_kernels"][0][1] == pytest.approx(200e-6)


def test_the_stretch_needs_its_ranges():
    with pytest.raises(ValueError):
        trace.reduce({"device": [], "ops": []}, {}, 1)


def run_input(summary):
    return {"chips": 1, "global_batch": 256, "setup_s": 21.5, "steps": 40,
            "step_s": 0.2, "memory_peak_bytes": 40 * 2 ** 30,
            "flops_per_step": 3 * 8.25e9 * 256, "peak_flops": 989e12,
            "bounds": {"conv_bwd": 25e-6}, "trace": summary,
            "host": {"steps": 3, "call_s": 0.3}}


def test_readers(summary):
    run = run_input(summary)
    read = {n: spec.metric_reader(n)(run) for n in (
        "train_step_ms", "peak_mem_gib", "setup_s", "step_mfu",
        "host_ms_per_step", "elementwise_ms", "gemm_conv_ms",
        "conv_bwd_roofline", "flash_roofline", "nccl_ms", "device_idle")}
    assert read["train_step_ms"] == pytest.approx(200.0)
    assert read["peak_mem_gib"] == pytest.approx(40.0)
    assert read["setup_s"] == 21.5
    assert read["step_mfu"] == pytest.approx(
        100 * 3 * 8.25e9 * 256 / 0.2 / 989e12)
    assert read["host_ms_per_step"] == pytest.approx(100.0)
    assert read["elementwise_ms"] == pytest.approx(0.15)   # 300 us / 2
    assert read["gemm_conv_ms"] == pytest.approx(0.15)
    assert read["conv_bwd_roofline"] == pytest.approx(50.0)
    assert read["flash_roofline"] is None
    assert read["nccl_ms"] == pytest.approx(0.05)
    assert read["device_idle"] == pytest.approx(25.0)


@pytest.mark.parametrize("twin", ["train_step_ms.dp", "device_idle.dp"])
def test_multi_card_twins_read_as_their_originals(summary, twin):
    run = run_input(summary)
    original = twin.removesuffix(".dp")
    assert spec.metric_reader(twin)(run) == pytest.approx(
        spec.metric_reader(original)(run))


def test_readers_with_nothing_to_read():
    run = run_input(None) | {"trace": None, "host": None, "bounds": {},
                             "peak_flops": None}
    for n in ("step_mfu", "host_ms_per_step", "elementwise_ms",
              "gemm_conv_ms", "conv_bwd_roofline", "flash_roofline",
              "nccl_ms", "device_idle", "device_idle.dp"):
        assert spec.metric_reader(n)(run) is None


def test_kernel_class():
    assert trace.kernel_class("flash_fwd_wgmma_kernel<64>") == "flash (port)"
    assert trace.kernel_class("ncclKernel_AllReduce") == "nccl"
    assert trace.kernel_class("Memset (Device)") == "casts and copies"
