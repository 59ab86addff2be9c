"""The port's schedule cost models (``fsdp_overlap_win``,
``gpipe_step_model``, ``ring_attention_model``, ``reference_overlap_win``)
against the JAX package's functions on a grid of the same inputs, to
1e-12 relative, the peak and the link passed to both; the overlap win at
the reference scale priced for an H100 SXM; the two-point GPipe bubble
against the analytic one; and ``train.peaks_for``, the name-keyed peak
table the cost models price a card with."""

import itertools
import math

import pytest
import torch

from kubeoperator_tpu.workloads import costmodel as jcm
from kubeoperator_tpu_torch.workloads import costmodel as cm
from kubeoperator_tpu_torch.workloads import pipeline as pl
from kubeoperator_tpu_torch.workloads import train as ttrain

torch.set_num_threads(2)

H100 = "NVIDIA H100 80GB HBM3"
LINKS = [(0.0, 450e9), (1e-6, 4.5e10), (1e-4, 2.5e10)]
PEAKS = [989e12, 1.97e14]
REL = 1e-12


def close(a, b) -> bool:
    """Every number of two (nested) results within ``REL`` relative."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return math.isclose(a, b, rel_tol=REL, abs_tol=1e-300)
    return a == b


def attribution(att) -> dict:
    return {"step_s": att.step_s, "compute_s": att.compute_s,
            "collective_s": dict(att.collective_s),
            "exposed_collective_s": att.exposed_collective_s,
            "ici_hops": att.ici_hops,
            "bubble_fraction": att.bubble_fraction, "source": att.source}


def links(lat, rate):
    return cm.LinkModel(lat, rate), jcm.LinkModel(lat, rate)


@pytest.mark.parametrize("n_layers,n_fsdp", [(1, 1), (4, 2), (32, 8),
                                             (12, 4)])
def test_fsdp_overlap_win_equals_the_reference(n_layers, n_fsdp):
    for (lat, rate), peak, pbytes, flops in itertools.product(
            LINKS, PEAKS, (4e6, 8.05e8), (1e9, 5.5e12)):
        mine, ref = links(lat, rate)
        kw = dict(n_layers=n_layers, layer_param_bytes=pbytes,
                  fwd_flops_per_layer=flops, n_fsdp=n_fsdp, peak_flops=peak)
        got = cm.fsdp_overlap_win(link=mine, **kw)
        want = jcm.fsdp_overlap_win(link=ref, **kw)
        assert close(got, want), (kw, got, want)


@pytest.mark.parametrize("pp", [1, 2, 4, 8])
def test_gpipe_step_model_equals_the_reference(pp):
    for (lat, rate), peak, micro, flops, hop, overhead in itertools.product(
            LINKS, PEAKS, (1, 4, 8), (1e9, 3.4e12), (1e3, 4.2e6),
            (0.0, 2e-3)):
        mine, ref = links(lat, rate)
        kw = dict(pp=pp, microbatches=micro, stage_fwd_flops_per_micro=flops,
                  hop_bytes=hop, peak_flops=peak, overhead_s=overhead)
        got = attribution(cm.gpipe_step_model(link=mine, **kw))
        want = attribution(jcm.gpipe_step_model(link=ref, **kw))
        assert close(got, want), (kw, got, want)


@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_ring_attention_model_equals_the_reference(sp):
    for (lat, rate), peak, seq, heads, hd, nbytes in itertools.product(
            LINKS, PEAKS, (8192, 32768), (4, 32), (16, 128), (2, 4)):
        mine, ref = links(lat, rate)
        kw = dict(seq_len=seq, sp=sp, batch=1, heads=heads, head_dim=hd,
                  peak_flops=peak, bytes_per_elem=nbytes)
        got = attribution(cm.ring_attention_model(link=mine, **kw))
        want = attribution(jcm.ring_attention_model(link=ref, **kw))
        assert close(got, want), (kw, got, want)


def test_reference_overlap_win_on_an_h100():
    """The reference scale priced for the H100 SXM (989 TFLOP/s, NVLink
    450 GB/s a way): the reference's own fsdp_overlap_win on the same
    inputs, and speedups 1.0, 1.258, 1.385 and 1.448 at fsdp 1-8."""
    peak, link = ttrain.peaks_for(H100)[0], cm.link_for(H100)
    assert (peak, link.latency_s, link.bytes_per_s) == (989e12, 0.0, 450e9)
    assert cm.REFERENCE_LLM == {k: v for k, v in jcm.REFERENCE_LLM.items()
                                if k != "peak_flops"}
    speedups = []
    for n in (1, 2, 4, 8):
        got = cm.reference_overlap_win(n, peak_flops=peak, link=link)
        lp = jcm.REFERENCE_LLM["layer_params"]
        want = jcm.fsdp_overlap_win(
            n_layers=jcm.REFERENCE_LLM["n_layers"],
            layer_param_bytes=4 * lp,
            fwd_flops_per_layer=2 * lp * jcm.REFERENCE_LLM["seq_len"],
            n_fsdp=n, peak_flops=peak, link=jcm.LinkModel(0.0, 450e9))
        assert close(got, want)
        speedups.append(got["speedup"])
    assert speedups == [1.0, 1.258, 1.385, 1.448]


@pytest.mark.parametrize("pp,micro", [(2, 8), (4, 8), (4, 16), (8, 32)])
def test_gpipe_two_point_bubble_near_the_analytic(pp, micro):
    """The bubble the model measures from two simulated step times is
    within 10% of (pp − 1)/(M + pp − 1) (exact with no overhead)."""
    peak, link = ttrain.peaks_for(H100)[0], cm.link_for(H100)
    analytic = pl.bubble_fraction(pp, micro)
    for overhead in (0.0, 1e-4):
        att = cm.gpipe_step_model(pp=pp, microbatches=micro,
                                  stage_fwd_flops_per_micro=2e12,
                                  hop_bytes=1e6, peak_flops=peak, link=link,
                                  overhead_s=overhead)
        assert abs(att.bubble_fraction - analytic) <= 0.10 * analytic
    assert cm.gpipe_step_model(
        pp=pp, microbatches=micro, stage_fwd_flops_per_micro=2e12,
        hop_bytes=1e6, peak_flops=peak,
        link=link).bubble_fraction == pytest.approx(analytic, rel=1e-12)


def test_peaks_for_names_and_refusals():
    assert ttrain.peaks_for(H100) == (989e12, 3.35e12)
    assert ttrain.peaks_for("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    with pytest.raises(ValueError, match="unknown card"):
        ttrain.peaks_for("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no published peak"):
        ttrain.peak_flops_per_chip("cpu")
