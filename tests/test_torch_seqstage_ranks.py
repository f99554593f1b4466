"""The ``seq`` and ``stage`` mesh axes over ranks, on the CPU with gloo.

Two worlds of ``tests/torch_seqstage_worker.py`` run side by side, W = 2 and
W = 4, each rank a process started by the port's ``launch`` on one CPU
thread. Every rank's outputs are held:

* against the JAX package on W devices of the virtual CPU mesh, run as its
  own tests run it (``shard_map``, the Pallas kernels interpreted): the
  ring's ``ring_attention``, the ring / ring_flash ``TransformerLM`` with
  ``make_sequence_parallel_train_step``, the ring classifier's pooling
  (``tests/test_transformer.py::test_ring_classifier_pools_globally``),
  and the GPipe ``pipeline_apply`` / ``make_pipeline_train_step`` /
  ``make_pipelined_transformer_lm`` (``tests/test_pipeline.py``). Bars:
  f32 forwards 1e-5, gradients and parameters 1e-4;
* against the one-process port at the same axis size, run by the same rank
  on the same thread count: the pipeline bit for bit (its sums over ranks
  add exact zeros), the ring within 1e-5 (the loss and the gradients are
  summed over ranks in another order);
* against each other: parameters bit-equal on every rank.

The small configuration: 2 layers (the pipelined LM 4, which divide over 2
and 4 stages), width 64, 4 heads, sequence 256 (the pipelined LM 64), vocab
64, f32. The JAX references are computed in this process while the worlds
run.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_seqstage_worker as worker
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle
from p2pfl_tpu.models.transformer import TransformerClassifier as JaxTransformerClassifier
from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from p2pfl_tpu.models.transformer import causal_lm_loss as jax_causal_lm_loss
from p2pfl_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from p2pfl_tpu.parallel import pipeline as jax_pipeline
from p2pfl_tpu.parallel.sequence import make_sequence_parallel_train_step as jax_train_step
from p2pfl_tpu.parallel.sequence import sequence_parallel_apply as jax_sp_apply
from p2pfl_tpu.parallel.sequence import sequence_parallel_lm_loss as jax_sp_loss
from p2pfl_tpu.utils.compat import shard_map
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.parallel.launch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
DEADLINE_S = 300.0
FWD, GRAD = 1e-5, 1e-4


def _jax_lm(kind, layers=worker.LAYERS):
    ring = kind in ("ring", "ring_flash")
    return JaxTransformerLM(vocab_size=worker.VOCAB, num_layers=layers, num_heads=worker.HEADS,
                            embed_dim=worker.EMBED, attention_kind=kind, axis_name="seq" if ring else None,
                            block_k=worker.BLOCK_K, compute_dtype=jnp.float32)


def _jax_classifier(kind):
    return JaxTransformerClassifier(num_classes=worker.CLASSES, vocab_size=worker.VOCAB, num_layers=worker.LAYERS,
                                    num_heads=worker.HEADS, embed_dim=worker.EMBED, attention_kind=kind,
                                    axis_name="seq" if kind == "ring" else None, block_k=worker.BLOCK_K,
                                    compute_dtype=jnp.float32)


def _jax_init():
    """The JAX package's initial weights: the ring LM (its blockwise twin
    has the same parameters), the classifier and the pipelined LM."""
    return {
        "lm": _jax_lm("blockwise").init(jax.random.key(0), jnp.zeros((1, worker.SEQ), jnp.int32)),
        "classifier": _jax_classifier("blockwise").init(jax.random.key(1), jnp.zeros((1, worker.SEQ), jnp.int32)),
        "pipeline_lm": _jax_lm("flash", worker.PP_LAYERS).init(jax.random.key(2),
                                                               jnp.zeros((1, worker.PP_SEQ), jnp.int32)),
    }


def _mesh(world, axis):
    return JaxMesh(np.array(jax.devices()[:world]), (axis,))


def _jax_ring(world, causal, impl):
    """``ring_attention`` under ``shard_map`` on W devices: its output and
    the gradients of q, k, v against the cotangent g."""
    q, k, v, g = map(jnp.asarray, worker.qkvg(3))
    spec = P(None, "seq", None, None)
    ring = jax.jit(shard_map(
        lambda q, k, v: jax_ring_attention(q, k, v, "seq", causal=causal, block_k=worker.BLOCK_K, impl=impl),
        mesh=_mesh(world, "seq"), in_specs=(spec, spec, spec), out_specs=spec, check_vma=False,
    ))
    out, vjp = jax.vjp(ring, q, k, v)
    return (out, *vjp(g))


def _jax_ring_lm(world, kind, params):
    """The ring LM on W devices: logits on the initial weights, then
    ``worker.STEPS`` Adam steps of ``make_sequence_parallel_train_step``
    (the first step's loss is the initial weights')."""
    jm, jmesh = _jax_lm(kind), _mesh(world, "seq")
    toks = jnp.asarray(worker.tokens(0))
    logits = np.asarray(jax.jit(jax_sp_apply(jm.apply, jmesh, "seq"))(params, toks))
    tx = optax.adam(worker.LR)
    step = jax_train_step(jm.apply, tx, jmesh, "seq")
    p, s, losses = params, tx.init(params), []
    for _ in range(worker.STEPS):
        p, s, l = step(p, s, toks)
        losses.append(float(l))
    return logits, losses, flax_to_torch(p, device="cpu")


def _jax_ring_classifier(world, params):
    """``tests/test_transformer.py::test_ring_classifier_pools_globally``'s
    program on W devices."""
    sp = jax.jit(shard_map(_jax_classifier("ring").apply, mesh=_mesh(world, "seq"), in_specs=(P(), P(None, "seq")),
                           out_specs=P(), check_vma=False))
    return np.asarray(sp(params, jnp.asarray(worker.tokens(4))))


def _jax_block(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_pipeline(world):
    """``pipeline_apply`` of the tanh block over W stages: the forward and
    the gradients of the mean squared error, then ``worker.BLOCK_STEPS``
    steps of ``make_pipeline_train_step``."""
    jmesh = _mesh(world, "stage")
    stacked = jax_pipeline.stack_stage_params([jax.tree.map(jnp.asarray, s) for s in worker.block_stages(2, world)],
                                              jmesh)
    x, y = map(jnp.asarray, worker.block_xy(3))

    def loss_fn(p):
        out = jax_pipeline.pipeline_apply(p, x, _jax_block, jmesh, worker.PP_MICRO)
        return jnp.mean((out - y) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(stacked)
    tx = optax.adam(1e-2)
    step = jax_pipeline.make_pipeline_train_step(_jax_block, lambda o, t: jnp.mean((o - t) ** 2), tx, jmesh,
                                                 worker.PP_MICRO)
    p, s, losses = stacked, tx.init(stacked), []
    for _ in range(worker.BLOCK_STEPS):
        p, s, l = step(p, s, x, y)
        losses.append(float(l))
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}, {k: np.asarray(v) for k, v in p.items()}, \
        losses


def _jax_full(pp, n_stages, per):
    """The JAX pipelined LM's params (or gradients) as the port's full dict."""
    inner = {"embed": pp["embed"], "ln_f": pp["ln_f"], "lm_head": pp["lm_head"]}
    for s in range(n_stages):
        for j in range(per):
            inner[f"block{s * per + j}"] = jax.tree.map(lambda a, s=s: a[s], pp["stages"][f"b{j}"])
    return flax_to_torch({"params": inner}, device="cpu")


def _jax_pipelined_lm(world, params):
    """``make_pipelined_transformer_lm`` over W stages: the logits and
    gradients on the initial weights, and ``worker.STEPS`` Adam steps."""
    jm, jmesh = _jax_lm("flash", worker.PP_LAYERS), _mesh(world, "stage")
    handle = JaxModelHandle(params=params, apply_fn=jm.apply, model_def=jm)
    pp, apply_fn = jax_pipeline.make_pipelined_transformer_lm(handle, jmesh, worker.PP_MICRO)
    toks = jnp.asarray(worker.tokens(5, worker.PP_BATCH, worker.PP_SEQ))

    def loss_fn(p):
        logits = apply_fn(p, toks)
        return jax_causal_lm_loss(logits, toks), logits

    tx = optax.adam(worker.LR)

    @jax.jit
    def step(p, s):
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g, logits

    p, s, losses = pp, tx.init(pp), []
    for i in range(worker.STEPS):
        p, s, l, g, lg = step(p, s)
        losses.append(float(l))
        if i == 0:
            grads, logits = g, np.asarray(lg)
    per = worker.PP_LAYERS // world
    return logits, _jax_full(grads, world, per), _jax_full(p, world, per), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(worlds, refs)``: both worlds' saved results, ``{W: [rank 0's,
    ...]}``, after each rank exited 0 (its output is in the assertion
    otherwise), and the JAX references, computed while the worlds ran."""
    init = _jax_init()
    out_dir = tmp_path_factory.mktemp("seqstage")
    torch.save({k: flax_to_torch(v, device="cpu") for k, v in init.items()}, out_dir / "init.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    env.pop("JAX_PLATFORMS", None)
    got = {}

    def start(world):
        got[world] = launch([sys.executable, os.path.join(ROOT, "tests", "torch_seqstage_worker.py"), str(out_dir)],
                            world, timeout_s=DEADLINE_S, env=env, cwd=ROOT)

    threads = [threading.Thread(target=start, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    try:
        refs = {}
        for world in WORLDS:
            for impl in ("blockwise", "flash"):
                for causal in (True, False):
                    refs["ring", world, impl, causal] = _jax_ring(world, causal, impl)
            for kind in ("ring", "ring_flash"):
                refs["ring_lm", world, kind] = _jax_ring_lm(world, kind, init["lm"])
            refs["classifier", world] = _jax_ring_classifier(world, init["classifier"])
            refs["pipeline", world] = _jax_pipeline(world)
            refs["pipeline_lm", world] = _jax_pipelined_lm(world, init["pipeline_lm"])
    finally:
        for t in threads:
            t.join()
    for world in WORLDS:
        for rank, (rc, out) in enumerate(got[world]):
            assert rc == 0, f"world {world} rank {rank} exited {rc}:\n{out[-4000:]}"
            assert f"WORKER_DONE rank={rank} world={world}" in out, out[-2000:]
    worlds = {w: [torch.load(out_dir / f"w{w}_r{r}.pt", weights_only=False) for r in range(w)] for w in WORLDS}
    return worlds, refs


def _local(a, world, rank):
    """Rank ``rank``'s sequence shard of a global ``[B, S, ...]`` array."""
    return np.array_split(np.asarray(a), world, axis=1)[rank]


def _close(got, want, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0, err_msg=what)


def _equal_on_every_rank(ranks, pick):
    first = pick(ranks[0])
    for got in ranks[1:]:
        for k, v in pick(got).items():
            assert torch.equal(v, first[k]), (got["rank"], k)


# --- collectives --------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_ppermute_moves_and_its_gradient_is_the_inverse_permute(world, runs):
    for got in runs[0][world]:
        c, r = got["collectives"], got["rank"]
        right = (r + 1) % world  # the ring sends to the left: rank r receives r + 1's
        assert torch.equal(c["y"], torch.full((3, 2), float(right + 1)))
        # x went to r - 1, whose weights scale the cotangent sent back.
        assert torch.equal(c["gx"], torch.arange(6.0).reshape(3, 2) + 10 * ((r - 1) % world))
        f, i = c["pair"]
        if r == world - 1:
            assert torch.equal(f, torch.full((4,), 0.5)) and torch.equal(i, torch.arange(2, dtype=torch.int64))
        else:
            assert not f.any() and not i.any() and i.dtype == torch.int64
        assert c["route"] == "direct"


@pytest.mark.parametrize("world", WORLDS)
def test_ppermute_counts_the_bytes_that_arrive(world, runs):
    for got in runs[0][world]:
        c, r = got["collectives"], got["rank"]
        assert c["ring_bytes"] == 2 * 3 * 2 * 4  # forward and backward, a [3, 2] f32 each
        assert c["bytes"] == c["ring_bytes"] + (4 * 4 + 2 * 8 if r == world - 1 else 0)


@pytest.mark.parametrize("world", WORLDS)
def test_psum_pmean_and_replicate_follow_their_gradient_rules(world, runs):
    total = world * (world + 1) / 2
    for got in runs[0][world]:
        c = got["collectives"]
        assert c["psum"].tolist() == [total, 2.0 * world]
        assert c["gpsum"].tolist() == [1.0, 3.0]  # the identity
        assert c["pmean"].tolist() == [total / world, 2.0] and c["gpmean"].tolist() == [1 / world] * 2
        assert c["replicate"].tolist() == [float(world - 1)] * 2
        owner = got["rank"] == world - 1
        assert c["greplicate"].tolist() == ([2.0, 2.0] if owner else [0.0, 0.0])  # the masked psum's rule


# --- the seq axis -------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["blockwise", "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_over_ranks_matches_jax_and_one_process(world, impl, causal, runs):
    ref = runs[1]["ring", world, impl, causal]
    for got in runs[0][world]:
        r = got["rank"]
        mine, one = got["ring"][(impl, causal)]["ranks"], got["ring"][(impl, causal)]["one"]
        for i, what in enumerate(("out", "dq", "dk", "dv")):
            _close(mine[i], _local(ref[i], world, r), FWD if i == 0 else GRAD, f"{what} rank {r}")
            _close(mine[i], _local(one[i].numpy(), world, r), FWD, f"{what} vs one process")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["ring", "ring_flash"])
def test_ring_lm_over_ranks_matches_jax_and_one_process(world, kind, runs):
    logits, losses, params = runs[1]["ring_lm", world, kind]
    ranks = runs[0][world]
    for got in ranks:
        r, mine, one = got["rank"], got["ring_lm"][kind]["ranks"], got["ring_lm"][kind]["one"]
        _close(mine["logits"], _local(logits, world, r), FWD, f"logits rank {r}")
        _close(mine["logits"], _local(one["logits"].numpy(), world, r), FWD, "logits vs one process")
        assert abs(mine["loss"] - losses[0]) < FWD and abs(mine["loss"] - one["loss"]) < FWD
        np.testing.assert_allclose(mine["losses"], losses, atol=FWD, rtol=0)
        assert mine["losses"][-1] < mine["losses"][0]
        for name, p in mine["params"].items():
            _close(p, params[name].numpy(), GRAD, f"{name} rank {r}")
            _close(p, one["params"][name].numpy(), FWD, f"{name} vs one process")
    _equal_on_every_rank(ranks, lambda got: got["ring_lm"][kind]["ranks"]["params"])


@pytest.mark.parametrize("world", WORLDS)
def test_ring_classifier_pools_globally_over_ranks(world, runs):
    ref = runs[1]["classifier", world]
    for got in runs[0][world]:
        c = got["classifier"]
        assert c["ranks"].shape == (worker.BATCH, worker.CLASSES)
        _close(c["ranks"], ref, FWD, f"rank {got['rank']}")
        _close(c["ranks"], c["one"].numpy(), FWD, "vs one process")


# --- the stage axis -----------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_over_ranks_matches_jax_and_is_bit_equal_to_one_process(world, runs):
    out, grads, params, losses = runs[1]["pipeline", world]
    for got in runs[0][world]:
        r, mine, one = got["rank"], got["pipeline"]["ranks"], got["pipeline"]["one"]
        assert torch.equal(mine["out"], one["out"])
        _close(mine["out"], out, FWD, f"forward rank {r}")
        np.testing.assert_allclose(mine["losses"], losses, atol=FWD, rtol=0)
        assert mine["losses"] == one["losses"] and mine["losses"][-1] < mine["losses"][0]
        for k in ("w", "b"):
            assert mine["grads"][k].shape[0] == 1 and mine["params"][k].shape[0] == 1  # this rank's stage
            assert torch.equal(mine["grads"][k][0], one["grads"][k][r])
            assert torch.equal(mine["params"][k][0], one["params"][k][r])
            _close(mine["grads"][k][0], grads[k][r], GRAD, f"grad {k} rank {r}")
            _close(mine["params"][k][0], params[k][r], GRAD, f"param {k} rank {r}")


def _full(pp_flat, per, rank=None):
    """Pipelined LM leaves (``"group/name"``) as the model's ``{name:
    tensor}``: every stage, or only ``rank``'s (leading axis 1)."""
    out = {}
    for key, t in pp_flat.items():
        group, name = key.split("/", 1)
        if group != "stages":
            out[name] = t
            continue
        j, leaf = name[1:].split(".", 1)
        for s in ([rank] if rank is not None else range(t.shape[0])):
            out[f"blocks.{s * per + int(j)}.{leaf}"] = t[0 if rank is not None else s]
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_lm_over_ranks_matches_jax_and_is_bit_equal_to_one_process(world, runs):
    logits, ref_grads, ref_params, losses = runs[1]["pipeline_lm", world]
    per = worker.PP_LAYERS // world
    micro = worker.PP_BATCH // worker.PP_MICRO * worker.PP_SEQ * worker.EMBED * 4
    ranks = runs[0][world]
    for got in ranks:
        r, mine, one = got["rank"], got["pipeline_lm"]["ranks"], got["pipeline_lm"]["one"]
        assert torch.equal(mine["logits"], one["logits"])
        _close(mine["logits"], logits, FWD, f"logits rank {r}")
        np.testing.assert_allclose(mine["losses"], losses, atol=FWD, rtol=0)
        assert mine["losses"] == one["losses"] and mine["losses"][-1] < mine["losses"][0]
        for what, ref in (("grads", ref_grads), ("params", ref_params)):
            whole = _full(one[what], per)
            for name, t in _full(mine[what], per, r).items():
                assert torch.equal(t, whole[name]), (what, name, r)
                _close(t, ref[name].numpy(), GRAD, f"{what} {name} rank {r}")
        # A rank receives a microbatch's activation each forward but stage 0's, and its
        # cotangent each backward but the last stage's: (no-grad forward + steps) x M.
        fwd, bwd = (r > 0) * (1 + worker.STEPS), (r < world - 1) * worker.STEPS
        assert mine["bytes"] == (fwd + bwd) * worker.PP_MICRO * micro, (r, mine["bytes"])
    _equal_on_every_rank(ranks, lambda got: {k: v for k, v in got["pipeline_lm"]["ranks"]["params"].items()
                                             if not k.startswith("stages/")})
