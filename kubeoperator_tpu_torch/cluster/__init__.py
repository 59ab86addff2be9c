"""Cluster-tier serving of the PyTorch port, the counterpart of
``kubeoperator_tpu/cluster/``: the ``ServeGateway`` routing tier over N
batcher replicas (sticky prefix hashing, load spill-over, gateway-level
requeue on replica loss, multi-tenant QoS, model groups) and the
disaggregated prefill→decode page handoff. The model lifecycle
(``lifecycle.py``: rollouts, the weight pool) is driven by the control
plane, which stays the JAX package's, and is not copied."""

from kubeoperator_tpu_torch.cluster.disagg import PrefillWorker, aligned_prefix
from kubeoperator_tpu_torch.cluster.gateway import (
    DEFAULT_MODEL, POLICIES, PRIORITIES, QOS_MODES, AggregateStats,
    ServeGateway, ShedError, UnknownModelError,
)

__all__ = ["DEFAULT_MODEL", "POLICIES", "PRIORITIES", "QOS_MODES",
           "AggregateStats", "PrefillWorker", "ServeGateway", "ShedError",
           "UnknownModelError", "aligned_prefix"]
