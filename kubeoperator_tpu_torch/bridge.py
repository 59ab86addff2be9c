"""Parameters from the JAX package's flax models to the port's state dicts:
``params_from_jax`` for the ``Transformer``, ``vit_params_from_jax`` for
the ``VisionTransformer``, ``resnet_params_from_jax`` for the ``ResNet``
(params and batch stats).

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


# flax's auto-names inside a ResNet block -> the port's module names; the
# projections keep their explicit names (proj_conv, proj_bn, proj_fused)
_BLOCK_NAMES = {
    "BottleneckBlock": {"Conv_0": "conv1", "BatchNorm_0": "bn1",
                        "Conv_1": "conv2", "BatchNorm_1": "bn2",
                        "Conv_2": "conv3", "BatchNorm_2": "bn3"},
    # a fused block: FusedConvBN units around the 3x3 conv, which is then
    # the block's first Conv (conv_vjp.Conv and nn.Conv share the counter)
    "FusedBottleneckBlock": {"FusedConvBN_0": "fused1", "Conv_0": "conv2",
                             "BatchNorm_0": "bn2", "FusedConvBN_1": "fused3"},
    "BasicBlock": {"Conv_0": "conv1", "BatchNorm_0": "bn1",
                   "Conv_1": "conv2", "BatchNorm_1": "bn2"},
}


def resnet_params_from_jax(variables: Mapping, cfg) -> dict[str, torch.Tensor]:
    """State dict for ``kubeoperator_tpu_torch.workloads.resnet.ResNet``
    (built from ``cfg``, a ``TrainConfig`` or anything with ``depth``) from
    flax ``ResNet`` variables: ``{"params": ..., "batch_stats": ...}``,
    leaves as numpy or jax arrays. Blocks are ``{Bottleneck,Basic}Block_i``
    numbered in creation order (the dict lists them sorted as text); a
    block holding ``FusedConvBN_0`` is a fused one."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    kind = "BottleneckBlock" if cfg.depth >= 50 else "BasicBlock"
    sd: dict[str, torch.Tensor] = {}

    def copy(prefix: str, p: Mapping, s: Mapping) -> None:
        for leaf, value in {**p, **s}.items():
            sd[f"{prefix}.{leaf}"] = _tensor(value)

    for name, tree in params.items():
        if not name.startswith(kind + "_"):
            copy(name, tree, stats.get(name, {}))
            continue
        i = int(name[len(kind) + 1:])
        table = _BLOCK_NAMES[("Fused" + kind) if "FusedConvBN_0" in tree
                             else kind]
        for sub, leaves in tree.items():
            copy(f"blocks.{i}.{table.get(sub, sub)}", leaves,
                 stats.get(name, {}).get(sub, {}))
    return sd
