"""Carry weights and Adam state across from the JAX package's formats.

flax keeps parameters as a nested dict (``{"params": {"block0": {"attn":
{"qkv": {"kernel": ...}}}}}``); the port keeps a flat dict under the torch
module's names (``"blocks.0.attn.qkv.weight"``). Each leaf has a layout:

- a Dense ``kernel`` is ``[in, out]`` and becomes ``Linear.weight`` ``[out,
  in]`` (the last two axes swapped);
- a ``Conv`` kernel (a module named ``Conv_<n>``) is HWIO ``[kh, kw, in,
  out]`` and becomes ``Conv2d.weight`` OIHW ``[out, in, kh, kw]``;
- LayerNorm and GroupNorm ``scale`` and Embed ``embedding`` become
  ``weight``, unchanged;
- ``bias`` and the MoE's stacked expert kernels ``wi [X, E, M]`` / ``wo
  [X, M, E]`` keep their names and layout.

The JAX package's canonical leaves (:func:`to_canonical`) keep flax's
layouts, so frames and hashes agree across the two packages. Every function
also takes stacked leaves (a leading node axis), as a population or its
optimizer state holds them. Inputs are anything numpy can read (numpy or
JAX arrays); outputs are torch tensors or numpy arrays. This module imports
no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.optim import AdamState

Params = Dict[str, torch.Tensor]

_BLOCK = re.compile(r"^block(\d+)$")
_KEPT_LEAVES = ("bias", "wi", "wo")  # names and layouts the port shares with flax


def _flatten(tree: Mapping, prefix: tuple = ()) -> Dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (str(key),)))
        else:
            out[prefix + (str(key),)] = val
    return out


def _kernel_kind(module: str) -> str:
    return "conv" if module.startswith("Conv") else "dense"


def _to_torch_axes(ndim: int, kind: Optional[str]) -> Optional[Tuple[int, ...]]:
    """The permutation taking a flax leaf of layout ``kind`` to the port's
    (``None``: the same layout); leading axes (a node stack) stay put."""
    if kind == "dense":
        return (*range(ndim - 2), ndim - 1, ndim - 2)
    if kind == "conv":  # [.., H, W, I, O] -> [.., O, I, H, W]
        return (*range(ndim - 4), ndim - 1, ndim - 2, ndim - 4, ndim - 3)
    return None


def _to_flax_axes(ndim: int, kind: Optional[str]) -> Optional[Tuple[int, ...]]:
    """Inverse of :func:`_to_torch_axes`."""
    axes = _to_torch_axes(ndim, kind)
    return None if axes is None else tuple(int(i) for i in np.argsort(axes))


def _torch_name(path: tuple) -> tuple[str, Optional[str]]:
    """flax path -> (torch name, the leaf's kernel layout: "dense", "conv" or None)."""
    parts = [f"blocks.{m.group(1)}" if (m := _BLOCK.match(p)) else p for p in path]
    leaf = parts[-1]
    if leaf in ("kernel", "scale", "embedding"):
        parts[-1] = "weight"
    elif leaf not in _KEPT_LEAVES:
        raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    return ".".join(parts), (_kernel_kind(path[-2]) if leaf == "kernel" else None)


def flax_to_torch(flax_params: Mapping, device: DeviceLike = "cuda") -> Params:
    """flax params (with or without the top ``"params"`` key) -> port f32 params."""
    dev = resolve_device(device)
    tree = flax_params["params"] if "params" in flax_params else flax_params
    out = {}
    for path, leaf in _flatten(tree).items():
        name, kind = _torch_name(path)
        arr = np.asarray(leaf, dtype=np.float32)
        axes = _to_torch_axes(arr.ndim, kind)
        if axes is not None:
            arr = np.transpose(arr, axes)
        out[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32, device=dev)
    return out


def flax_path(name: str) -> Tuple[Tuple[str, ...], Optional[str]]:
    """Port parameter name -> (its flax path, the leaf's kernel layout:
    ``"dense"``, ``"conv"`` or ``None``): ``"blocks.0.attn.qkv.weight"`` ->
    ``(("block0", "attn", "qkv", "kernel"), "dense")``."""
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
        elif module.startswith(("ln", "GroupNorm")):
            leaf = "scale"
        else:
            return (*path, "kernel"), _kernel_kind(module)
    return (*path, leaf), None


def canonical_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape parameter ``name`` of the port's ``shape`` has among the
    canonical leaves (flax's layout)."""
    axes = _to_flax_axes(len(shape), flax_path(name)[1])
    return tuple(shape) if axes is None else tuple(shape[i] for i in axes)


def canonical_names(names: Iterable[str]) -> List[str]:
    """The port's parameter names in the JAX package's canonical leaf order:
    ``jax.tree.leaves`` of the flax tree, i.e. nested dict keys sorted."""
    return sorted(names, key=lambda n: flax_path(n)[0])


def to_canonical(params: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    """Port params -> the JAX package's canonical leaves (its
    ``ModelHandle.get_parameters()`` order and layout: Dense kernels ``[in,
    out]``, Conv kernels HWIO), as contiguous tensors on the params' device."""
    out = []
    for name in canonical_names(params):
        t = params[name]
        axes = _to_flax_axes(t.dim(), flax_path(name)[1])
        out.append((t if axes is None else t.permute(axes)).contiguous())
    return out


def from_canonical(names: Iterable[str], leaves: Sequence[torch.Tensor]) -> Params:
    """Inverse of :func:`to_canonical` for the parameter ``names``: canonical
    leaves -> ``{name: tensor}`` in the port's layout."""
    order = canonical_names(names)
    if len(order) != len(leaves):
        raise ValueError(f"expected {len(order)} leaves, got {len(leaves)}")
    out = {}
    for name, t in zip(order, leaves):
        axes = _to_torch_axes(t.dim(), flax_path(name)[1])
        out[name] = t if axes is None else t.permute(axes).contiguous()
    return out


def torch_to_flax(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port params -> flax-structured nested dict of numpy arrays (inverse of
    :func:`flax_to_torch`), under a top ``"params"`` key."""
    root: Dict[str, Any] = {}
    for name, t in params.items():
        path, kind = flax_path(name)
        arr = t.detach().float().cpu().numpy()
        axes = _to_flax_axes(arr.ndim, kind)
        if axes is not None:
            arr = np.transpose(arr, axes)
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
