"""2-D rank meshes (``nodes`` x ``model``, ``batch`` x ``seq``), the dryrun
over real ranks and a rank's share of the round's cost, on the CPU with gloo.

Two worlds of ``tests/torch_mesh2d_worker.py`` run, each rank a process
started by the port's ``launch`` on one CPU thread: four ranks on the 2 x 2
layouts, then two ranks on ``{"nodes": 1, "model": 2}`` and on two ``nodes``
ranks. Every rank's outputs are held:

* against the JAX package on 2 x 2 devices of the virtual CPU mesh, run as
  its own tests run it, in a process of its own
  (``tests/torch_mesh2d_refs.py``): ``MeshSimulation`` on ``make_mesh((2,
  2), ("nodes", "model"))`` (the f32 MLP with FedAdam, the f32 flash LM;
  test loss and parameters within 1e-5), and
  ``make_sequence_parallel_train_step(..., batch_axis="batch")`` of the ring
  and ring_flash LMs on a ``("batch", "seq")`` mesh (logits and losses
  within 1e-5, parameters after two steps within 1e-4);
* against the same population on ``{"nodes": 1, "model": 2}`` ranks: bit for
  bit (the same slices, only moved between ranks);
* against each other: the batch x seq parameters bit-equal on every rank;
* the sub-groups' byte counters against the formulas below, the 2 x 2
  checkpoint restored bit-equal at 2 x 2, on ``{"nodes": 1, "model": 2}``,
  on two ``nodes`` ranks and in one process, and ``round_cost_analysis``
  against a count built from the one-process analysis' per-member terms
  and the split kernels' share.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh2d_refs as refs_mod
import torch_mesh2d_worker as worker
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.parallel.launch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 300.0
FWD, GRAD = 1e-5, 1e-4


def _jax_init():
    """The JAX package's initial weights, as the port's leaves."""
    return {
        "mlp": flax_to_torch(refs_mod.jax_mlp().init(jax.random.key(0), jnp.zeros((1, 28, 28))), device="cpu"),
        "lm": flax_to_torch(refs_mod.jax_lm().init(jax.random.key(1), jnp.zeros((1, worker.LM_SEQ), jnp.int32)),
                            device="cpu"),
        "seq": flax_to_torch(refs_mod.JaxTransformerLM(
            vocab_size=worker.SEQ_VOCAB, num_layers=worker.SEQ_LAYERS, num_heads=worker.SEQ_HEADS,
            embed_dim=worker.SEQ_EMBED, attention_kind="blockwise", block_k=worker.SEQ_BLOCK,
            compute_dtype=jnp.float32).init(jax.random.key(2), jnp.zeros((1, worker.SEQ_LEN), jnp.int32)),
            device="cpu"),
    }


def _world(out_dir, mode, world, env):
    got = launch([sys.executable, os.path.join(ROOT, "tests", "torch_mesh2d_worker.py"), str(out_dir), mode], world,
                 timeout_s=DEADLINE_S, env=env, cwd=ROOT)
    for rank, (rc, out) in enumerate(got):
        assert rc == 0, f"{mode} rank {rank} exited {rc}:\n{out[-4000:]}"
        assert f"WORKER_DONE rank={rank} world={world}" in out, out[-2000:]
    return [torch.load(out_dir / f"{mode}_r{r}.pt", weights_only=False) for r in range(world)]


def _one_process(out_dir, init):
    """In this process, on one thread as every rank runs: the 2 x 2
    checkpoint restored whole, and the one-process cost analyses of each
    arm at committee ``COST_K`` and 1."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        restored = worker._restore(None, init, str(out_dir / "ckpt"))
        cost = {(arm, k): worker.make_sim(arm, init, None, k).round_cost_analysis()
                for arm in ("mlp", "lm") for k in (worker.COST_K, 1)}
    finally:
        torch.set_num_threads(threads)
    return restored, cost


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"w4": [rank 0's, ...], "w2": [...], "refs": ..., "one": ...}``
    after each rank exited 0 (its output is in the assertion otherwise);
    the JAX references are computed while the worlds run."""
    init = _jax_init()
    out_dir = tmp_path_factory.mktemp("mesh2d")
    torch.save(init, out_dir / "init.pt")
    env = {**os.environ, "PYTHONPATH": ROOT}
    with open(out_dir / "refs.log", "w+") as log:
        refs_proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_mesh2d_refs.py"),
                                      str(out_dir)], env={**env, "JAX_PLATFORMS": "cpu"}, cwd=ROOT, stdout=log,
                                     stderr=subprocess.STDOUT)
        try:
            wenv = {**env, "OMP_NUM_THREADS": "1"}
            w4 = _world(out_dir, "w4", 4, wenv)
            w2 = _world(out_dir, "w2", 2, wenv)  # restores w4's checkpoint
            refs_proc.wait(timeout=DEADLINE_S)
        finally:
            if refs_proc.poll() is None:
                refs_proc.kill()
                refs_proc.wait()
        log.seek(0)
        assert refs_proc.returncode == 0, f"the JAX references exited {refs_proc.returncode}:\n{log.read()[-4000:]}"
    return {"w4": w4, "w2": w2, "refs": torch.load(out_dir / "refs.pt", weights_only=False),
            "one": _one_process(out_dir, init)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if dataclasses.is_dataclass(tree):
        return {k2: v2 for f in dataclasses.fields(tree) for k2, v2 in _flat(getattr(tree, f.name),
                                                                             f"{prefix}/{f.name}").items()}
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def _bit_equal(got, want, what):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), (what, sorted(set(got) ^ set(want))[:4])
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), (what, k)


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0, err_msg=what)


# --- the meshes and their sub-groups --------------------------------------------


def test_2d_rank_meshes_lay_ranks_out_row_major_with_a_sub_group_per_axis(runs):
    for got in runs["w4"]:
        r, m = got["rank"], got["meshes"]
        i, j = divmod(r, 2)
        for names in (("nodes", "model"), ("batch", "seq")):
            assert m[names]["rank_axes"] == names and m[names]["coords"] == [i, j]
            # Along the first axis the ranks that share j, along the second those that share i.
            assert m[names]["groups"] == [[j, 2 + j], [2 * i, 2 * i + 1]], (r, names, m[names]["groups"])
        assert m[("nodes", "model")]["slab"] == (4 * i, 4 * i + 4)
        assert m["batch"] == {"rank_axes": ("batch",), "coords": [r]}


def test_the_pairs_no_jax_program_runs_raise_naming_their_roadmap_item(runs):
    for got in runs["w4"]:
        refused = got["meshes"]["refused"]
        assert set(refused) == {("nodes", "seq"), ("nodes", "stage"), ("seq", "expert")}
        for axes, msg in refused.items():
            assert msg is not None and "ROADMAP queue A item A12" in msg, (axes, msg)


def test_collectives_take_sub_group_ranks_and_count_bytes_per_axis(runs):
    for got in runs["w4"]:
        r, c = got["rank"], got["collectives"]
        i, j = divmod(r, 2)
        # Along nodes: the rank at nodes 0 brings one row, at nodes 1 two, each 10 i + j.
        assert c["gathered"].tolist() == [[float(j)] * 3, [10.0 + j] * 3, [10.0 + j] * 3]
        assert c["bcast"].tolist() == [2.0 * i + 1] * 2  # model sub-group rank 1 is global rank 2 i + 1
        assert c["one"] == 2 + j  # nodes sub-group rank 1 is global rank 2 + j
        assert c["ppermute"].tolist() == [float(2 * i + 1 - j)] * 5  # the other seq rank of the same batch row
        assert c["psum"].tolist() == [2.0] * 3
        zero = dict.fromkeys(c["stats"]["nodes"], 0)
        assert c["stats"] == {
            "nodes": {**zero, "all_gather_bytes": 3 * 3 * 4, "broadcast_bytes": 8},
            "model": {**zero, "broadcast_bytes": 2 * 4},
            "seq": {**zero, "ppermute_bytes": 5 * 4},
            "batch": {**zero, "sum_bytes": 3 * 4},
        }


# --- MeshSimulation on nodes x model -----------------------------------------------


@pytest.mark.parametrize("arm", ["mlp", "lm"])
def test_2x2_round_is_bit_equal_to_model_ranks_and_matches_jax(arm, runs):
    loss, node0 = runs["refs"]["sims"][arm]
    model = runs["w2"][0]["sims"][arm]
    for other in runs["w2"][1:]:
        _bit_equal(other["sims"][arm]["final"], model["final"], f"{arm} w2 rank {other['rank']}")
    for got in runs["w4"]:
        mine = got["sims"][arm]
        assert mine["test_loss"] == model["test_loss"]
        _bit_equal(mine["final"], model["final"], f"{arm} final, rank {got['rank']}")
        _bit_equal(mine["state"], model["state"], f"{arm} state, rank {got['rank']}")
        np.testing.assert_allclose(mine["test_loss"], loss, atol=FWD, rtol=0)
        for name, t in mine["final"].items():
            _close(t, node0[name], FWD, f"{arm} {name} rank {got['rank']}")


@pytest.mark.parametrize("arm", ["mlp", "lm"])
def test_2x2_rank_keeps_its_slab_cut_to_its_model_slice_and_trains_its_members(arm, runs):
    for got in runs["w4"]:
        mine = got["sims"][arm]
        # Round 0's committee on both slabs, round 1's on the first alone.
        assert mine["rank_members"] == [[2, 2], [4, 0]]
        for name, shape in mine["local"].items():
            whole = mine["final"][name].shape
            d = mine["dims"].get(name)
            want = (worker.NODES // 2, *[n // 2 if k == d else n for k, n in enumerate(whole)])
            assert shape == want, (name, shape, want)
        assert mine["dims"] == runs["w2"][0]["sims"][arm]["dims"]


def _local_bytes(got, arm):
    return 4 * sum(int(np.prod(s[1:])) for s in got["sims"][arm]["local"].values())


def _sub_group_bytes(arm, got):
    """``AXIS_STATS`` of a 2 x 2 run of ``SCHED``: along ``nodes`` the K
    gathered member rows a round (this rank's slice of each leaf, the loss
    and the devobs update norm, f32); along ``model`` the column-parallel
    layers' gathered outputs a forward pass (training and eval) and, a
    training step, the summed input cotangents, the whole biases' gradients
    and, a member, its devobs norm; in the world the devobs flag (f64) a
    round, the test values (f32) and each save's token."""
    i = got["rank"] // 2
    trained = sum(len([n for n in row if n // 4 == i]) for row in worker.SCHED)
    rounds, k = len(worker.SCHED), len(worker.SCHED[0])
    row = _local_bytes(got, arm) + 4 + 4
    if arm == "mlp":
        outs, ins = sum(worker.MLP_HIDDEN) + 10, sum(worker.MLP_HIDDEN)  # every layer split at 2; the inputs of 1, 2
        b, steps, test = worker.SAMPLES, 1, 64  # one batch a member
        gather = 4 * outs * (trained * steps * b + rounds * test)
        summed = trained * (steps * 4 * (b * ins + outs) + 4)
        saves = rounds * 16
    else:
        e, layers, t = worker.LM_EMBED, worker.LM_LAYERS, worker.LM_SEQS * worker.LM_SEQ  # one step a member
        gather = 4 * (e + layers * 9 * e + worker.LM_VOCAB) * t * (trained + rounds)
        summed = trained * (4 * (t * (layers * 7 * e + e) + layers * 5 * e) + 4)
        saves = 0
    zero = dict.fromkeys(got["sims"][arm]["stats"]["nodes"], 0)
    return {"nodes": {**zero, "all_gather_bytes": rounds * k * row},
            "model": {**zero, "gather_dim_bytes": gather, "sum_bytes": summed},
            "world": {**zero, "reduce_bytes": 8 * rounds, "broadcast_bytes": 4 * 2 * rounds + saves}}


@pytest.mark.parametrize("arm", ["mlp", "lm"])
def test_2x2_round_moves_the_bytes_of_its_formula_on_each_sub_group(arm, runs):
    for got in runs["w4"]:
        assert got["sims"][arm]["stats"] == _sub_group_bytes(arm, got), got["rank"]


@pytest.mark.parametrize("where", ["2x2", "model", "nodes", "one process"])
def test_2x2_checkpoint_restores_bit_equal_at_every_layout(where, runs):
    want = runs["w4"][0]["sims"]["mlp"]["state"]
    if where == "one process":
        got = [runs["one"][0]]
    else:
        got = [g["restore"][where] for g in runs["w4" if where == "2x2" else "w2"]]
    for restored in got:
        assert restored["rounds"] == len(worker.SCHED)
        _bit_equal(restored["state"], want, where)


# --- the LM on batch x seq ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["ring", "ring_flash"])
def test_batch_x_seq_lm_matches_jax_with_parameters_bit_equal_on_every_rank(kind, runs):
    logits, loss, losses, params = runs["refs"]["seq"][kind]
    half = worker.SEQ_LEN // 2
    for got in runs["w4"]:
        i, j = divmod(got["rank"], 2)
        mine = got["seq"][kind]
        assert mine["tokens"].tolist() == worker.seq_tokens()[i:i + 1, j * half:(j + 1) * half].tolist()
        _close(mine["logits"], logits[i:i + 1, j * half:(j + 1) * half], FWD, f"{kind} logits rank {got['rank']}")
        assert abs(mine["loss"] - loss) < FWD and mine["losses"][0] == mine["loss"]
        np.testing.assert_allclose(mine["losses"], losses, atol=FWD, rtol=0)
        for name, p in mine["params"].items():
            _close(p, params[name], GRAD, f"{kind} {name} rank {got['rank']}")
        _bit_equal(mine["params"], runs["w4"][0]["seq"][kind]["params"], f"{kind} rank {got['rank']}")


def test_batch_x_seq_train_step_refuses_a_ranked_batch_axis_it_is_not_given(runs):
    for got in runs["w4"]:
        msg = got["seq"]["unnamed_batch"]
        assert msg is not None and "['batch']" in msg and "batch_axis" in msg, msg


@pytest.mark.parametrize("kind", ["ring", "ring_flash"])
def test_batch_x_seq_step_moves_the_bytes_of_its_formula_on_each_sub_group(kind, runs):
    """A step: along ``seq`` each layer's (k, v) rotation (f32), once in the
    forward and once in the backward's inverse permute, plus the ring_flash
    backward's rematerialized forward, and the first token of the right
    neighbour (int32); the loss' sum and count (f32) along ``seq`` and then
    along ``batch``; in the world the gradients' sum (f32) and, on the
    first step, rank 0's parameters."""
    e, layers = worker.SEQ_EMBED, worker.SEQ_LAYERS
    kv = 2 * (worker.SEQ_BATCH // 2) * (worker.SEQ_LEN // 2) * e * 4
    passes = 3 if kind == "ring_flash" else 2
    params = 4 * sum(t.numel() for t in runs["w4"][0]["seq"][kind]["params"].values())
    steps = worker.STEPS
    for got in runs["w4"]:
        stats = got["seq"][kind]["stats"]
        zero = dict.fromkeys(stats["seq"], 0)
        assert stats == {"seq": {**zero, "ppermute_bytes": steps * (passes * layers * kv + 4), "sum_bytes": 8 * steps},
                         "batch": {**zero, "sum_bytes": 8 * steps},
                         "world": {**zero, "reduce_bytes": steps * params, "broadcast_bytes": params}}


# --- the dryrun and the cost analysis over ranks -------------------------------------


def test_dryrun_multichip_runs_every_phase_over_four_ranks_and_rank_0_alone_prints(runs):
    lines = runs["w4"][0]["dryrun"]["full"]["printed"].splitlines()
    assert [ln.split(" OK")[0] for ln in lines] == [
        "dryrun_multichip", "dryrun sequence-parallel", "dryrun expert-parallel", "dryrun pipeline-parallel",
        "dryrun robust-aggregation"], lines
    assert "mesh={'nodes': 2, 'model': 2}" in lines[0] and "over 4 devices" in lines[1]
    for got in runs["w4"]:
        assert got["dryrun"]["full"]["ran"] == ["core", "sequence", "expert", "pipeline", "robust"]
        assert got["rank"] == 0 or got["dryrun"]["full"]["printed"] == ""


def test_dryrun_budget_skip_is_rank_0s_and_every_rank_takes_it(runs):
    """Rank 0's budget is 0 and the others' 1e9: every rank stops after the
    core phase, where a rank that went on would wait for its peers forever."""
    for got in runs["w4"]:
        assert got["dryrun"]["skip"]["ran"] == ["core"]
    assert "skipping sequence/expert-parallel phases" in runs["w4"][0]["dryrun"]["skip"]["printed"]


def _members_by_row(rows):
    from p2pfl_tpu_torch.learning.learner import seeded_generator
    from p2pfl_tpu_torch.parallel.simulation import vote_committee

    committee = vote_committee(seeded_generator(0, 0, 0), worker.NODES, worker.COST_K).tolist()
    per = worker.NODES // rows
    return [sum(n // per == i for n in committee) for i in range(rows)]


@pytest.mark.parametrize("arm", ["mlp", "lm"])
def test_round_cost_analysis_over_ranks_is_a_ranks_share(arm, runs):
    """From the one-process analyses at committee K and 1: a member's FLOPs
    T and the rest E (the eval), each split into attention and the dense
    products. A rank counts the members of its slab, its half of every dense
    product (every kernel splits at 2) and attention in full."""
    full, one = runs["one"][1][arm, worker.COST_K], runs["one"][1][arm, 1]
    k = worker.COST_K

    def terms(key):
        t = (full[key] - one[key]) / (k - 1)
        return t, full[key] - k * t

    t_a, e_a = terms("attention_flops_per_round")
    t_all, e_all = terms("flops_per_round")
    t_d, e_d = t_all - t_a, e_all - e_a

    def want(members, model):
        attn = members * t_a + e_a
        return (members * t_d + e_d) / model + attn, attn

    rows = _members_by_row(2)
    cases = [(f"2x2 rank {g['rank']}", g["cost"][arm], want(rows[g["rank"] // 2], 2)) for g in runs["w4"]]
    cases += [(f"model rank {g['rank']}", g["cost"]["model"][arm], want(k, 2)) for g in runs["w2"]]
    cases += [(f"nodes rank {g['rank']}", g["cost"]["nodes"][arm], want(rows[g["rank"]], 1)) for g in runs["w2"]]
    for what, got, (flops, attn) in cases:
        assert got is not None, what
        assert got["flops_per_round"] == flops and got["attention_flops_per_round"] == attn, (what, got, flops, attn)
    assert (arm == "mlp") == (t_a == 0)
