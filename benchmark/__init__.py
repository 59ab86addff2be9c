"""The benchmark of ``kubeoperator_tpu_torch``, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, metrics and bounds; this
folder holds everything they are measured with: the harness, one file of
sizes and one plain reference per configuration (``configs/``), one data
file per traffic mix (``traffic/``), one reader per metric (``metrics/``)
and one file of correctness limits per cell (``limits/``). Nothing here
imports JAX or the JAX package.
"""
