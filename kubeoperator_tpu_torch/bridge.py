"""Parameters from the JAX package's flax models to the port's state dicts:
``params_from_jax`` for the ``Transformer``, ``vit_params_from_jax`` for
the ``VisionTransformer``.

The port keeps the flax layouts, so the bridge is a copy: it walks the
(``nn.unbox``-ed, numpy) param tree and names each leaf the way the port's
modules do. Both layer layouts are taken: the ``nn.scan``-stacked tree
(``params["layers"][...]`` with a leading axis of length L) and the
unrolled one (``params["layers"]["layers_{i}"]``, ``scan_layers=False``);
fused ``qkv`` and split ``q``/``k``/``v`` projections alike. Values stay
f32, as the flax masters are.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _layer_tree(layers: Mapping, i: int, stacked: bool) -> Mapping:
    if not stacked:
        return layers[f"layers_{i}"]

    def pick(tree):
        if isinstance(tree, Mapping):
            return {k: pick(v) for k, v in tree.items()}
        return np.asarray(tree)[i]

    return pick(layers)


def _blocks_from_jax(layers: Mapping, n_layers: int) -> dict[str, torch.Tensor]:
    """``layers.{i}.*`` entries of the port's ``Block`` stack from a flax
    ``layers`` tree, stacked or unrolled."""
    stacked = not any(str(k).startswith("layers_") for k in layers)
    sd = {}
    for i in range(n_layers):
        lp = _layer_tree(layers, i, stacked)
        if "moe" in lp:
            raise NotImplementedError("MoE params are not ported yet "
                                      "(ROADMAP queue 1, MoE slice)")
        pre = f"layers.{i}."
        attn = lp["attn"]
        names = ("qkv",) if "qkv" in attn else ("q", "k", "v")
        for name in names + ("o",):
            sd[pre + f"attn.{name}"] = _tensor(attn[name]["kernel"])
        for name in ("gate", "up", "down"):
            sd[pre + f"mlp.{name}"] = _tensor(lp["mlp"][name]["kernel"])
        sd[pre + "ln1.scale"] = _tensor(lp["ln1"]["scale"])
        sd[pre + "ln2.scale"] = _tensor(lp["ln2"]["scale"])
    return sd


def params_from_jax(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """State dict for ``kubeoperator_tpu_torch.workloads.transformer.
    Transformer(cfg)`` from a flax ``Transformer`` param tree (the
    ``"params"`` collection, unboxed, leaves as numpy or jax arrays)."""
    return {"embedding": _tensor(params["embedding"]),
            "ln_f.scale": _tensor(params["ln_f"]["scale"]),
            **_blocks_from_jax(params["layers"], cfg.n_layers)}


def vit_params_from_jax(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """State dict for ``kubeoperator_tpu_torch.workloads.vit.
    VisionTransformer(cfg)`` from a flax ``VisionTransformer`` param tree:
    the patch conv (HWIO kernel and bias), the encoder blocks, ``ln_f``
    and the head (kernel and bias)."""
    sd = {f"{name}.{leaf}": _tensor(params[name][leaf])
          for name in ("patch_embed", "head") for leaf in ("kernel", "bias")}
    sd["ln_f.scale"] = _tensor(params["ln_f"]["scale"])
    sd.update(_blocks_from_jax(params["layers"], cfg.encoder.n_layers))
    return sd
