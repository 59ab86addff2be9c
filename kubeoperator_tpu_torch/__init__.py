"""PyTorch/CUDA port of the kubeoperator_tpu workload layer (H100)."""
