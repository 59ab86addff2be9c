"""The warm catalog: pre-build the kernel libraries of known
configurations, the counterpart of ``kubeoperator_tpu/aot/warm.py``.

``python -m kubeoperator_tpu_torch.aot warm`` runs this so that the first
bring-up of a worker on a machine lands on a populated cache instead of
paying nvcc. Each entry constructs the real engine or trainer with
``compile_cache=``, which consults ``CompileCache.consult`` exactly as
production bring-up does: the entry written here has the key a later
worker computes. The key holds the card and the toolkit, so warming on
one kind of card gives entries another kind misses.

The reference's entries keep their names and sizes (``serve-smoke``,
``train-smoke``, ``serve-default``); in the port serving builds nothing,
and the ResNet at the reference's defaults builds ``batch_norm`` (its
BatchNorm's kernels). Two entries are the port's own: ``train-k7k8``
(``profile_lm.RESNET_K7_K8``, the ``conv_bwd`` and ``batch_norm``
libraries) and ``lm-bench`` (``profile_lm.BENCH_LM``, the
``flash_attention`` library).
"""

from __future__ import annotations

from typing import Any, Callable

from kubeoperator_tpu_torch.aot.cache import CompileCache


def _warm_serve(cache: CompileCache, device, *, vocab: int, d_model: int,
                n_heads: int, n_layers: int, d_ff: int, max_seq_len: int,
                slots: int, segment: int) -> Any:
    import torch

    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.train import resolve_device
    from kubeoperator_tpu_torch.workloads.transformer import (
        Transformer, TransformerConfig,
    )

    cfg = TransformerConfig(vocab_size=vocab, d_model=d_model,
                            n_heads=n_heads, n_layers=n_layers, d_ff=d_ff,
                            max_seq_len=max_seq_len, dtype=torch.float32)
    dev = resolve_device(device)
    with torch.device(dev):
        model = Transformer(cfg).reset_parameters(0).eval()
    eng = SlotPoolEngine(cfg, model, slots=slots, segment=segment,
                         compile_cache=cache, device=dev)
    return eng.aot


def _warm_train(cache: CompileCache, device, *, batch_size: int,
                image_size: int, num_classes: int, depth: int) -> Any:
    from kubeoperator_tpu_torch.workloads.train import TrainConfig, Trainer

    cfg = TrainConfig(batch_size=batch_size, image_size=image_size,
                      num_classes=num_classes, depth=depth,
                      warmup_steps=2, total_steps=10)
    return Trainer(cfg, compile_cache=cache, device=device).aot


def _warm_profiled(cache: CompileCache, device, *, config: str) -> Any:
    """A configuration of ``profile_lm`` through its trainer."""
    from kubeoperator_tpu_torch import profile_lm
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.train import Trainer

    cfg = getattr(profile_lm, config)
    trainer = Trainer if config == "RESNET_K7_K8" else LMTrainer
    return trainer(cfg, compile_cache=cache, device=device).aot


# name -> (builder, kwargs). The smoke entries are the reference's (what
# its image hook warms); the "default" entry its deployed serving config;
# the last two are the configurations that launch the port's kernels.
CATALOG: dict[str, tuple[Callable[..., Any], dict]] = {
    "serve-smoke": (_warm_serve, dict(vocab=64, d_model=32, n_heads=4,
                                      n_layers=2, d_ff=64, max_seq_len=24,
                                      slots=4, segment=4)),
    "train-smoke": (_warm_train, dict(batch_size=8, image_size=32,
                                      num_classes=10, depth=18)),
    "serve-default": (_warm_serve, dict(vocab=256, d_model=128, n_heads=8,
                                        n_layers=4, d_ff=512,
                                        max_seq_len=256, slots=16,
                                        segment=8)),
    "train-k7k8": (_warm_profiled, dict(config="RESNET_K7_K8")),
    "lm-bench": (_warm_profiled, dict(config="BENCH_LM")),
}


def warm(cache: CompileCache, names: list[str] | None = None, *,
         device=None, emit: Callable[[str], None] = lambda s: None
         ) -> list[dict]:
    """Bring up every requested catalog entry through the cache (on the
    card unless ``device`` says otherwise); return one row per entry with
    its libraries, the hit/miss outcome and bring-up seconds. Unknown
    names raise (a typo'd warm catalog must not silently warm
    nothing)."""
    picked = names or ["serve-smoke", "train-smoke"]
    unknown = [n for n in picked if n not in CATALOG]
    if unknown:
        raise KeyError(f"unknown warm catalog "
                       f"entr{'y' if len(unknown) == 1 else 'ies'}: "
                       f"{unknown} (have: {sorted(CATALOG)})")
    rows: list[dict] = []
    for entry in picked:
        builder, kwargs = CATALOG[entry]
        res = builder(cache, device, **kwargs)
        row = {"entry": entry, "function": res.name,
               "libraries": [r.name for r in res.libraries],
               "fingerprint": res.fingerprint, "hit": res.hit,
               "seconds": round(res.seconds, 4), "source": res.source}
        rows.append(row)
        emit(f"warm {entry}: {'hit' if row['hit'] else 'built'} "
             f"{row['fingerprint']} in {row['seconds']}s")
    return rows
