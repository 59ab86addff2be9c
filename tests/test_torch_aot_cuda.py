"""The compile cache on the card with the real builder (nvcc): cold, then
warm, for ``conv_bwd`` (K7-K9) and ``flash_attention`` (K1-K6) in a fresh
cache directory. The cold consult builds each library once, the warm one
builds nothing and hits, the library the wrappers launch is the cache's
file, and K1 and K7 from the warm library match their plain versions
within chip_smoke.py's ``TOL`` (``LSE_TOL`` for the lse) and
``CONV_TOL``. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_aot_cuda.py

Without a card every test skips."""

from pathlib import Path

import pytest
import torch

from chip_smoke import CONV_TOL, LSE_TOL, TOL, errors
from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.analysis import compile_count_guard
from kubeoperator_tpu_torch.aot import CompileCache
from kubeoperator_tpu_torch.workloads import conv_vjp as tcv
from kubeoperator_tpu_torch.workloads import flash_attention as tfa

torch.set_num_threads(2)

LIBS = ("conv_bwd", "flash_attention")


@pytest.fixture(scope="module")
def warm_cache(tmp_path_factory):
    """Cold then warm through one fresh directory: each consult's result
    and its guard's counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    root = tmp_path_factory.mktemp("aot")
    saved = dict(kernels._installed)
    with compile_count_guard() as cold_guard:
        cold = CompileCache(str(root)).consult("test", LIBS)
    with compile_count_guard() as warm_guard:
        warm = CompileCache(str(root)).consult("test", LIBS)
    yield {"cold": cold, "warm": warm, "cold_guard": cold_guard,
           "warm_guard": warm_guard, "root": root}
    kernels._installed.clear()
    kernels._installed.update(saved)


@pytest.mark.gpu
def test_cold_builds_each_library_once_warm_none(warm_cache):
    cold, warm = warm_cache["cold"], warm_cache["warm"]
    assert not cold.hit and [r.source for r in cold.libraries] == [
        "compile", "compile"]
    warm_cache["cold_guard"].assert_single_compile()
    assert warm_cache["cold_guard"].by_function() == {
        n: {"signatures": 1, "traces": 1} for n in LIBS}
    warm_cache["warm_guard"].assert_zero_compiles()
    assert warm.hit and [r.source for r in warm.libraries] == ["cache",
                                                               "cache"]
    assert warm.fingerprint == cold.fingerprint
    for r in warm.libraries:
        assert Path(r.path).stat().st_size > 100_000
        assert Path(r.path).is_relative_to(warm_cache["root"])


@pytest.mark.gpu
def test_k1_from_the_warm_library_matches_plain(warm_cache):
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, t, d = 8, 512, 128
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    tfa.reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, d ** -0.5, True, t)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, d ** -0.5, True, t)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_fwd"] == 1
    path = next(r.path for r in warm_cache["warm"].libraries
                if r.name == "flash_attention")
    assert kernels.loaded_path("flash_attention") == Path(path).resolve()
    for got, want, tol in ((o, o_p, TOL), (lse, lse_p, LSE_TOL)):
        err = errors(got, want, tol)
        assert err["within"], err


@pytest.mark.gpu
def test_k7_from_the_warm_library_matches_plain(warm_cache):
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, ci, co = 6272, 512, 2048
    x, g = (torch.randn(n, c, device="cuda", generator=gen)
            .to(torch.bfloat16) for c in (ci, co))
    w = (torch.randn(ci, co, device="cuda", generator=gen) * 0.05).to(
        torch.bfloat16)
    tcv.reset_launches()
    dx, dw = tcv.conv1x1_bwd(x, g, w)
    dx_p, dw_p = tcv.conv1x1_bwd_plain(x, g, w)
    torch.cuda.synchronize()
    assert tcv.LAUNCHES == {"conv1x1_bwd_dx": 1, "conv1x1_bwd_dw": 1}
    path = next(r.path for r in warm_cache["warm"].libraries
                if r.name == "conv_bwd")
    assert kernels.loaded_path("conv_bwd") == Path(path).resolve()
    for got, want, what in ((dx, dx_p, "dx"), (dw, dw_p, "dw")):
        err = errors(got, want, CONV_TOL)
        assert err["within"], (what, err)
