"""``kernels.ptxas_report`` reads each kernel's registers, spills and
warnings from nvcc's ``-Xptxas -v`` output; ``chip_smoke.py`` prints it in
its build phase. Runs on the CPU: the log is a sample of nvcc's format."""

import pytest
import torch

from kubeoperator_tpu_torch import kernels

torch.set_num_threads(2)

DQ = ("_ZN12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi128EEEv14CUtensorMap_"
      "stS1_S1_S1_PKfS3_P13__nv_bfloat16ifii")
K5 = ("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64ELb1EEEvPK13__nv_bfloat16"
      "S3_S3_S3_PKfS5_PS1_iifii")
LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{DQ}' for 'sm_90a'
ptxas info    : Function properties for {DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 600 bytes cmem[0]
ptxas info    : Compiling entry function '{K5}' for 'sm_90a'
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Function properties for {K5}
    16 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 424 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    rep = kernels.ptxas_report(LOG)
    dq, k5 = "flash_bwd_dq_wgmma_kernel<128>", "flash_bwd_dq_kernel<64,1>"
    assert set(rep) == {dq, k5}
    assert rep[dq] == {"warnings": [], "stack": 0, "spill_stores": 0,
                       "spill_loads": 0, "registers": 168}
    assert rep[k5]["registers"] == 255
    assert (rep[k5]["spill_stores"], rep[k5]["spill_loads"]) == (24, 32)
    assert rep[k5]["warnings"] == [
        "ptxas warning : (C7508) setmaxnreg ignored; unable to determine "
        "register count at entry"]


@pytest.mark.parametrize("mangled,name", [
    # this nvcc's anonymous namespace carries a file id of its own; the
    # older one ends in a digit that runs into the length (1 + 15)
    ("_ZN51_GLOBAL__N__1696aaf6_18_flash_attention_cu_fdbb1a2c22flash_fwd_"
     "wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfifii",
     "flash_fwd_wgmma_kernel<64>"),
    ("_ZN12_GLOBAL__N_115k7_wgmma_kernelILb1EEEv14CUtensorMap_stS1_S1_Pviiiii",
     "k7_wgmma_kernel<1>"),
    # K4 (and K1) with the head count, K8's two products
    ("_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_"
     "S1_P13__nv_bfloat16Pfiifii", "flash_fwd_wgmma_kernel<64>"),
    ("_ZN12_GLOBAL__N_118k8_dx_wgmma_kernelILi128ELb1EEEv14CUtensorMap_stS1_"
     "S1_S1_NS_2BnEiii", "k8_dx_wgmma_kernel<128,1>"),
    ("_ZN12_GLOBAL__N_118k8_dw_wgmma_kernelILi1ELi2ELi128ELb0EEEv14CUtensorM"
     "ap_stS1_S1_PfNS_2BnEiiiii", "k8_dw_wgmma_kernel<1,2,128,0>"),
    ("_Z6kernelPf", "_Z6kernelPf")])
def test_kernel_name(mangled, name):
    assert kernels.kernel_name(mangled) == name


def test_ptxas_report_of_a_cached_build_is_empty():
    # a library found already built keeps no ptxas output
    assert kernels.ptxas_report("") == {}


@pytest.mark.parametrize("name", [
    "k8_dx_wgmma_kernel<128,1>", "k8_dw_wgmma_kernel<2,1,64,0>",
    "k7_wgmma_kernel<1>", "colsum_kernel<1>", "reduce_chunks_kernel"])
def test_profile_counts_the_conv_backward_kernels(name):
    # profile_lm's device-time classes see K7 and K8 by kernel name
    from kubeoperator_tpu_torch.profile_lm import kernel_class
    assert kernel_class(name) == "conv backward K7/K8 (port)"
