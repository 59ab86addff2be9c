"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It prints, as the last line of its standard output, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` also ``breakdown``), and as the last lines of its standard
error each number compared against its limit. Without a card, or with
fewer than the cell asks for, it exits with 2 and prints no result. The
kernels' build and every cache stay inside the checkout, under ``build/``.
"""

import time

START = time.time()     # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def environment() -> None:
    """Caches at fixed paths inside the checkout; no library may pull in
    JAX on its own."""
    cache = ROOT / "build" / "portbench"
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


if __name__ == "__main__":
    environment()
    import torch

    torch.set_num_threads(2)
    from benchmark.harness import driver

    sys.exit(driver.main(sys.argv[1:], START))
