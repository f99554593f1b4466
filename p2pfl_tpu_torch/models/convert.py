"""Carry weights and Adam state across from the JAX package's formats.

flax keeps parameters as a nested dict (``{"params": {"block0": {"attn":
{"qkv": {"kernel": ...}}}}}``); the port keeps a flat dict under the torch
module's names (``"blocks.0.attn.qkv.weight"``). A Dense ``kernel`` is
``[in, out]`` and becomes ``Linear.weight`` ``[out, in]``; LayerNorm
``scale`` and Embed ``embedding`` become ``weight``. Every function also
takes stacked leaves (a leading node axis), as a population or its optimizer
state holds them. Inputs are anything numpy can read (numpy or JAX arrays);
outputs are torch tensors or numpy arrays. This module imports no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.optim import AdamState

Params = Dict[str, torch.Tensor]

_BLOCK = re.compile(r"^block(\d+)$")


def _flatten(tree: Mapping, prefix: tuple = ()) -> Dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (str(key),)))
        else:
            out[prefix + (str(key),)] = val
    return out


def _torch_name(path: tuple) -> tuple[str, bool]:
    """flax path -> (torch name, whether the leaf is a Dense kernel)."""
    parts = [f"blocks.{m.group(1)}" if (m := _BLOCK.match(p)) else p for p in path]
    leaf = parts[-1]
    if leaf in ("kernel", "scale", "embedding"):
        parts[-1] = "weight"
    elif leaf != "bias":
        raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    return ".".join(parts), leaf == "kernel"


def flax_to_torch(flax_params: Mapping, device: DeviceLike = "cuda") -> Params:
    """flax params (with or without the top ``"params"`` key) -> port f32 params."""
    dev = resolve_device(device)
    tree = flax_params["params"] if "params" in flax_params else flax_params
    out = {}
    for path, leaf in _flatten(tree).items():
        name, is_kernel = _torch_name(path)
        arr = np.asarray(leaf, dtype=np.float32)
        if is_kernel:
            arr = np.swapaxes(arr, -1, -2)
        out[name] = torch.tensor(arr, dtype=torch.float32, device=dev)
    return out


def flax_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """Port parameter name -> (its flax path, whether the leaf is a Dense
    kernel): ``"blocks.0.attn.qkv.weight"`` -> ``(("block0", "attn", "qkv",
    "kernel"), True)``."""
    parts = name.split(".")
    path = []
    i = 0
    while i < len(parts) - 1:
        if parts[i] == "blocks":
            path.append(f"block{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    module, leaf = path[-1], parts[-1]
    if leaf == "weight":
        if module == "embed":
            leaf = "embedding"
        elif module.startswith("ln"):
            leaf = "scale"
        else:
            return (*path, "kernel"), True
    return (*path, leaf), False


def canonical_names(names: Iterable[str]) -> List[str]:
    """The port's parameter names in the JAX package's canonical leaf order:
    ``jax.tree.leaves`` of the flax tree, i.e. nested dict keys sorted."""
    return sorted(names, key=lambda n: flax_path(n)[0])


def to_canonical(params: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    """Port params -> the JAX package's canonical leaves (its
    ``ModelHandle.get_parameters()`` order and layout: Dense kernels ``[in,
    out]``), as contiguous tensors on the params' device."""
    out = []
    for name in canonical_names(params):
        t = params[name]
        out.append(t.transpose(-1, -2).contiguous() if flax_path(name)[1] else t.contiguous())
    return out


def from_canonical(names: Iterable[str], leaves: Sequence[torch.Tensor]) -> Params:
    """Inverse of :func:`to_canonical` for the parameter ``names``: canonical
    leaves -> ``{name: tensor}`` in the port's layout."""
    order = canonical_names(names)
    if len(order) != len(leaves):
        raise ValueError(f"expected {len(order)} leaves, got {len(leaves)}")
    return {
        name: (t.transpose(-1, -2).contiguous() if flax_path(name)[1] else t)
        for name, t in zip(order, leaves)
    }


def torch_to_flax(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port params -> flax-structured nested dict of numpy arrays (inverse of
    :func:`flax_to_torch`), under a top ``"params"`` key."""
    root: Dict[str, Any] = {}
    for name, t in params.items():
        path, is_kernel = flax_path(name)
        arr = t.detach().float().cpu().numpy()
        if is_kernel:
            arr = np.swapaxes(arr, -1, -2)
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": root}


def adam_state_from_optax(opt_state: Any, device: DeviceLike = "cuda") -> AdamState:
    """``optax.adam`` state -> :class:`AdamState`.

    ``opt_state`` is what ``optax.adam(lr).init`` (or a ``vmap`` of it)
    returns: a chain whose first element has ``count``, ``mu`` and ``nu``.
    """
    adam = opt_state[0] if isinstance(opt_state, (tuple, list)) else opt_state
    dev = resolve_device(device)
    return AdamState(
        mu=flax_to_torch(adam.mu, dev),
        nu=flax_to_torch(adam.nu, dev),
        count=torch.tensor(np.asarray(adam.count), dtype=torch.int32, device=dev),
    )
