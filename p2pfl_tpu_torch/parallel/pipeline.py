"""Pipeline parallelism: the GPipe microbatch schedule (counterpart of
``p2pfl_tpu/parallel/pipeline.py``), on one card.

The JAX package lays S stages along a ``stage`` mesh axis, one per device,
and streams M microbatches through them in ``M + S - 1`` ticks of a
``lax.scan``: each tick every stage applies its block and ``ppermute``\\ s the
activation to the next stage. On one card the stages share the device, so
the port keeps the schedule and its data movement but not the SPMD program:
stage parameters are stage-stacked (every leaf has a leading axis S), each
tick walks the stages, and the activation a stage produced moves into the
next stage's slot, as ``ppermute`` hands it over. Only the (stage,
microbatch) cells that hold data run: the JAX package's bubble cells
compute on zeros or a clipped microbatch and their outputs are never
emitted, so skipping them changes no output. Autograd differentiates
through the loop, so the backward pass runs through the same cells in
reverse.

Restriction, as in the JAX package: a block preserves the activation's shape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from p2pfl_tpu_torch.models.transformer import Block
from p2pfl_tpu_torch.optim import apply_updates, state_map
from p2pfl_tpu_torch.parallel.mesh import Mesh, axis_size

Pytree = Any
BlockFn = Callable[[Pytree, torch.Tensor], torch.Tensor]


def _stage(stage_params: Pytree, s: int) -> Pytree:
    return state_map(lambda a: a[s], stage_params)


def pipeline_spmd(block_fn: BlockFn, n_microbatches: int, axis_name: str = "stage") -> BlockFn:
    """The GPipe schedule over the stages of ``axis_name``: returns ``body(
    stage_params, x) -> y``, to run inside a :meth:`Mesh.bind` that binds
    ``axis_name`` (its size is the number of stages S, as ``psum(1,
    axis_name)`` is in the JAX package). ``stage_params`` is stage-stacked
    (leading axis S on every leaf); ``n_microbatches`` (M) must divide the
    batch."""

    def body(stage_params: Pytree, x: torch.Tensor) -> torch.Tensor:
        n_stages = axis_size(axis_name)
        batch = x.shape[0]
        if batch % n_microbatches:
            raise ValueError(f"batch {batch} must divide evenly into {n_microbatches} microbatches")
        micro = x.reshape(n_microbatches, batch // n_microbatches, *x.shape[1:])
        params = [_stage(stage_params, s) for s in range(n_stages)]
        slots: List[Optional[torch.Tensor]] = [None] * n_stages  # what each stage received last tick
        outputs: List[Optional[torch.Tensor]] = [None] * n_microbatches
        for t in range(n_microbatches + n_stages - 1):
            sent: List[Optional[torch.Tensor]] = [None] * n_stages
            for s in range(n_stages):
                m = t - s  # the microbatch at stage s in tick t
                if not 0 <= m < n_microbatches:
                    continue  # a bubble: no data at this stage this tick
                out = block_fn(params[s], micro[m] if s == 0 else slots[s])
                if s == n_stages - 1:
                    outputs[m] = out  # the last stage emits microbatch t - (S - 1)
                else:
                    sent[s + 1] = out
            slots = sent  # the ring-forward hop
        return torch.cat(outputs).reshape(batch, *x.shape[1:])

    return body


def pipeline_apply(
    stage_params: Pytree, x: torch.Tensor, block_fn: BlockFn, mesh: Mesh, n_microbatches: int,
    axis_name: str = "stage",
) -> torch.Tensor:
    """Apply the S stage-stacked stages (S = ``mesh``'s ``axis_name`` size)
    to ``x`` as a microbatch pipeline."""
    n_stages = mesh.check_axis(axis_name)
    for leaf in _leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(f"stage params have {leaf.shape[0]} stages, mesh axis {axis_name!r} has {n_stages}")
    with mesh.bind():
        return pipeline_spmd(block_fn, n_microbatches, axis_name)(stage_params, x)


def _leaves(tree: Pytree) -> List[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def sequential_apply(stage_params: Pytree, x: torch.Tensor, block_fn: BlockFn, n_stages: int) -> torch.Tensor:
    """What the pipeline must compute: the stages applied one after another."""
    for s in range(n_stages):
        x = block_fn(_stage(stage_params, s), x)
    return x


def make_pipeline_train_step(
    block_fn: BlockFn,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    optimizer: Any,
    mesh: Mesh,
    n_microbatches: int,
    axis_name: str = "stage",
) -> Callable:
    """``step(stage_params, opt_state, x, y) -> (params, opt_state, loss)``:
    the loss of the pipelined forward, its gradients through the same
    schedule, and one optimizer step (a port transformation of
    :mod:`p2pfl_tpu_torch.optim` over the stage-stacked leaves)."""

    def step(stage_params: Pytree, opt_state: Any, x: torch.Tensor, y: torch.Tensor):
        flat = _flatten(stage_params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        loss = loss_fn(pipeline_apply(_unflatten(leaves), x, block_fn, mesh, n_microbatches, axis_name), y)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, opt_state = optimizer.update(grads, opt_state, flat)
        return _unflatten(apply_updates(flat, updates)), opt_state, loss.detach()

    return step


def _flatten(tree: Pytree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts -> ``{"a/b": tensor}`` (the optimizers take flat dicts)."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Pytree:
    if set(flat) == {""}:
        return flat[""]
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return root


def stack_stage_params(params_list: List[Pytree], mesh: Optional[Mesh] = None, axis_name: str = "stage") -> Pytree:
    """Stack per-stage pytrees into the stage-stacked layout (leading axis S);
    with a ``mesh`` (which must have ``axis_name``) the leaves move to its
    device."""
    stacked = state_map(lambda *xs: torch.stack(xs), *params_list)
    if mesh is not None:
        mesh.check_axis(axis_name)
        stacked = state_map(lambda a: a.to(mesh.device), stacked)
    return stacked


class _Method(torch.nn.Module):
    """Runs one method of ``module`` as ``forward``, so ``functional_call``
    can apply it with given parameters (flax's ``apply(..., method=)``)."""

    def __init__(self, module: torch.nn.Module, method: str) -> None:
        super().__init__()
        self.module, self.method = module, method

    def forward(self, *args: Any) -> Any:
        return getattr(self.module, self.method)(*args)


def make_pipelined_transformer_lm(
    model: Any, mesh: Mesh, n_microbatches: int, axis_name: str = "stage",
) -> Tuple[Pytree, Callable[[Pytree, torch.Tensor], torch.Tensor]]:
    """Stage a :class:`~p2pfl_tpu_torch.models.transformer.TransformerLM`
    over the ``axis_name`` stages of ``mesh``.

    ``model`` is a handle from :func:`~p2pfl_tpu_torch.models.transformer.
    transformer_lm_model` whose attention needs no mesh axis of its own (not
    ``ring`` / ``ring_flash``). The blocks are stage-stacked (``num_layers``
    must divide evenly over the stages); embed, ``ln_f`` and ``lm_head`` stay
    whole. Returns ``(pipeline_params, apply_fn)``: ``pipeline_params`` is
    ``{"embed", "stages", "ln_f", "lm_head"}`` (each a ``{name: tensor}``
    dict; ``stages`` keyed ``"b<j>.<block param>"`` with leading axis S) and
    ``apply_fn(pipeline_params, tokens)`` equals ``model.apply(model.params,
    tokens)``."""
    module = model.module
    first = module.blocks[0].attn
    if first.attention_kind in ("ring", "ring_flash"):
        raise ValueError(
            "pipelined LM needs a per-stage attention kind (ring attention owns its own mesh axis); "
            "use 'blockwise', 'flash', or 'dense'"
        )
    n_stages, n_layers = mesh.check_axis(axis_name), len(module.blocks)
    if n_layers % n_stages:
        raise ValueError(f"num_layers={n_layers} must divide evenly over {n_stages} stages")
    per_stage = n_layers // n_stages
    block_names = [n for n, _ in module.blocks[0].named_parameters()]
    stage_trees = [
        {f"b{j}.{n}": model.params[f"blocks.{s * per_stage + j}.{n}"] for j in range(per_stage) for n in block_names}
        for s in range(n_stages)
    ]
    part = lambda prefix: {n: t for n, t in model.params.items() if n.startswith(prefix + ".")}  # noqa: E731
    pipeline_params = {
        "embed": part("embed"),
        "stages": stack_stage_params(stage_trees, mesh, axis_name),
        "ln_f": part("ln_f"),
        "lm_head": part("lm_head"),
    }
    with torch.device("meta"):
        block_mod = Block(module.embed.weight.shape[1], first.num_heads, first.attention_kind,
                          module.compute_dtype, None, first.block_k)
    embed, head = _Method(module, "embed_tokens"), _Method(module, "head")

    def block_fn(stage_params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        for j in range(per_stage):
            x = functional_call(block_mod, {n: stage_params[f"b{j}.{n}"] for n in block_names}, (x,))
        return x

    def apply_fn(params: Pytree, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.shape[0] % n_microbatches:
            raise ValueError(f"batch {tokens.shape[0]} must divide evenly into {n_microbatches} microbatches")
        x = functional_call(embed, {f"module.{n}": t for n, t in params["embed"].items()}, (tokens,))
        x = pipeline_apply(params["stages"], x, block_fn, mesh, n_microbatches, axis_name)
        return functional_call(
            head, {f"module.{n}": t for n, t in {**params["ln_f"], **params["lm_head"]}.items()}, (x,))

    return pipeline_params, apply_fn
