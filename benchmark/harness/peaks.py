"""Published peaks of the cards the benchmark knows, by device name.

A frozen copy of the port's table (``workloads/train.py::PEAKS``,
``peaks_for``): dense bf16 FLOP/s and HBM bytes/s from NVIDIA's data
sheets at the card's full power limit. A card the table does not know
raises rather than being guessed.
"""

from __future__ import annotations

# (device-name substring, bf16 dense FLOP/s, HBM bytes/s); the first match
# wins
PEAKS = (
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 sxm", 989e12, 3.35e12),
    ("h100 80gb hbm3", 989e12, 3.35e12),    # the SXM part's device name
    ("h200", 989e12, 4.8e12),
)


def peaks_for(name: str) -> tuple[float, float]:
    """(bf16 dense FLOP/s, HBM bytes/s) of the card ``name``, as
    ``torch.cuda.get_device_name`` gives it."""
    low = name.lower()
    for key, flops, hbm in PEAKS:
        if key in low:
            return flops, hbm
    raise ValueError(f"unknown card {name!r}: add its bf16 dense peak and "
                     f"HBM rate to PEAKS")


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time a piece of work can take: the larger of its
    operations over the peak rate and its bytes over the HBM rate."""
    return max(flops / peak_flops, nbytes / peak_bytes)
