"""The ``nodes`` mesh axis over ranks, on the CPU with gloo.

Two worlds of ``tests/torch_multirank_worker.py`` run side by side, W = 2 and
W = 4, each rank a process started by the port's ``launch`` with its own
deadline (the world is killed when it passes). In them:

* the counterpart of ``tests/test_multihost.py::test_two_process_mesh_fedavg_round``
  (W = 2): two processes join through ``initialize_multihost(coordinator,
  2, pid)`` and run one FedAvg round of the MLP ``MeshSimulation``; both
  report the accuracy of the one-process run;
* three arms of a small f32 flash LM (2 layers, width 64, sequence 64; the
  plain kernel versions on the CPU; local SGD, see ``ARMS``): a signflip node with
  ``clip_update_norm`` and ``server_optimizer="fedadam"``; SCAFFOLD; six
  nodes, which four ranks pad with two fillers never elected. Every rank
  of every world holds parameters bit-equal to the one-process run's (W =
  1, in this process), and each arm's one-process run is held to the JAX
  package's ``MeshSimulation`` on its 8-device CPU mesh, fed the same
  ``committee_schedule``, at 1e-5 on parameters and test loss (the bar of
  ``tests/test_torch_simulation.py``);
* the collectives with uneven row counts and mixed dtypes, and the
  refusals of what a rank mesh does not run yet.
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

import torch_multirank_worker as worker
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle
from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from p2pfl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
from p2pfl_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from p2pfl_tpu_torch.parallel.launch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
DEADLINE_S = 300.0


@pytest.fixture(scope="module")
def jax_init():
    module = JaxTransformerLM(vocab_size=worker.VOCAB, num_layers=worker.LAYERS, num_heads=worker.HEADS,
                              embed_dim=worker.EMBED, attention_kind="flash", compute_dtype=jnp.float32)
    return module, module.init(jax.random.key(0), jnp.zeros((1, worker.SEQ), jnp.int32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_init):
    """Both worlds' saved results, ``{W: [rank 0's, ...]}``, after each rank
    exited 0 (its output is in the assertion otherwise)."""
    out_dir = tmp_path_factory.mktemp("multirank")
    torch.save(flax_to_torch(jax_init[1], device="cpu"), out_dir / "init.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    env.pop("JAX_PLATFORMS", None)
    runs = {}

    def start(world):
        runs[world] = launch([sys.executable, os.path.join(ROOT, "tests", "torch_multirank_worker.py"), str(out_dir)],
                             world, timeout_s=DEADLINE_S, env=env, cwd=ROOT)

    threads = [threading.Thread(target=start, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for world in WORLDS:
        for rank, (rc, out) in enumerate(runs[world]):
            assert rc == 0, f"world {world} rank {rank} exited {rc}:\n{out[-4000:]}"
            assert f"WORKER_DONE rank={rank} world={world}" in out, out[-2000:]
    return {w: [dict(torch.load(out_dir / f"w{w}_r{r}.pt", weights_only=False), out=runs[w][r][1]) for r in range(w)]
            for w in WORLDS}


@pytest.fixture(scope="module")
def one_process(jax_init):
    """The arms in this process, on one CPU thread as every rank runs: the
    CPU's matrix products split their sums by the thread count."""
    init = flax_to_torch(jax_init[1], device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: worker.run_arm(name, init) for name in worker.ARMS}
    finally:
        torch.set_num_threads(threads)


def test_two_processes_join_and_run_one_mlp_fedavg_round(worlds):
    accs = {line.split("acc=")[1] for rank in worlds[2] for line in rank["out"].splitlines()
            if line.startswith("MULTIRANK_OK")}
    assert len(accs) == 1, accs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alone = worker._mlp(None)
    finally:
        torch.set_num_threads(threads)
    assert worlds[2][0]["mlp_acc"] == worlds[2][1]["mlp_acc"] == alone
    assert 0.0 <= worlds[2][0]["mlp_acc"] <= 1.0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arm", sorted(worker.ARMS))
def test_lm_arm_is_bit_equal_at_every_world_size(arm, world, worlds, one_process):
    ref = one_process[arm]
    nodes, sched, _ = worker.ARMS[arm]
    for got in worlds[world]:
        run = got["arms"][arm]
        np.testing.assert_array_equal(run["committees"], np.asarray(sched))
        assert run["test_loss"] == ref["test_loss"]
        for k, v in ref["final"].items():
            assert torch.equal(run["final"][k], v), (arm, world, got["rank"], k)
        for k, v in ref["params_stack"].items():
            assert torch.equal(run["params_stack"][k], v), (arm, world, got["rank"], k)
        # Members train where they are held: per round, the members of each rank.
        per = -(-nodes // world)
        assert run["rank_members"] == [[sum(n // per == r for n in row) for r in range(world)] for row in sched]
        assert all(b > 0 for b in run["gather_bytes"])
    assert ref["rank_members"] == [[len(row)] for row in sched] and ref["gather_bytes"] == [0, 0]


@pytest.mark.parametrize("arm", sorted(worker.ARMS))
def test_lm_arm_matches_the_jax_mesh_simulation_on_its_8_device_mesh(arm, jax_init, one_process):
    module, params = jax_init
    nodes, sched, kw = worker.ARMS[arm]
    x, y, mask, xt = worker.arm_data(nodes)
    kw = {"lr": worker.LR, **kw}
    if kw.pop("sgd", False):
        kw["optimizer"] = optax.sgd(kw["lr"])
    mesh = jax_make_mesh()
    assert mesh.shape["nodes"] == 8
    jsim = JaxMeshSimulation(JaxModelHandle(params=params, apply_fn=module.apply, model_def=module), (x, y, mask),
                             test_data=(xt, None), train_set_size=len(sched[0]), batch_size=worker.SEQS, seed=0,
                             task="lm", mesh=mesh, **kw)
    ref = jsim.run(rounds=worker.ROUNDS, epochs=1, warmup=False, committee_schedule=np.asarray(sched))
    ref_node0 = jax.tree.map(lambda a: np.asarray(a[0]), jsim.params_stack)
    got = one_process[arm]
    np.testing.assert_allclose(got["test_loss"], ref.test_loss, atol=1e-5, rtol=0)
    diffs = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b))), torch_to_flax(got["final"]), ref_node0)
    assert max(jax.tree.leaves(diffs)) < 1e-5, diffs


def test_collectives_gather_uneven_rows_of_every_dtype_in_rank_order_and_shard_populations(worlds):
    for world in WORLDS:
        for got in worlds[world]:
            c = got["collectives"]
            counts = [world - 1 - r for r in range(world)]
            gathered = c["gathered"]
            np.testing.assert_array_equal(
                gathered["f32"], torch.cat([torch.arange(n * 6, dtype=torch.float32).reshape(n, 2, 3) + 100 * r
                                            for r, n in enumerate(counts)]))
            assert gathered["bf16"].dtype == torch.bfloat16 and gathered["bf16"].shape == (sum(counts), 5)
            assert torch.equal(gathered["bf16"].float(), torch.cat([torch.full((n, 5), r + 0.5)
                                                                    for r, n in enumerate(counts)]))
            assert gathered["i64"].tolist() == [i + 1000 * r for r, n in enumerate(counts) for i in range(n)]
            assert gathered["bool"].dtype == torch.bool
            assert gathered["bool"][:, 0].tolist() == [r % 2 == 0 for r, n in enumerate(counts) for _ in range(n)]
            assert torch.equal(c["bcast"]["w"], torch.full((3, 2), float(world - 1)))
            assert int(c["bcast"]["c"]) == world - 1 and int(c["one"]) == 7 * (world - 1)
            assert float(c["sum"]) == world * (world + 1) / 2 and int(c["max"]) == world - 1
            # make_shard_and_gather_fns: a population leaf keeps this rank's slab and gathers whole.
            population = np.arange(world * 2 * 3, dtype=np.float32).reshape(world * 2, 3)
            r = got["rank"]
            np.testing.assert_array_equal(c["sharding"]["slab"].numpy(), population[2 * r:2 * r + 2])
            np.testing.assert_array_equal(c["sharding"]["whole"], population)
            np.testing.assert_array_equal(c["sharding"]["replicated"], population)


def test_what_a_rank_mesh_does_not_run_yet_raises_naming_its_roadmap_item(worlds):
    """A ``seq``, ``stage``, ``expert`` or ``model`` axis alone over the ranks
    builds (ported), and so do the MoE LM over a ranked seq axis, both
    population engines and a population's sharded checkpoint (save, load,
    ``run(checkpointer=)``, over nodes and over model ranks); two axes above
    1 (``nodes`` x ``model``, ``seq`` x ``expert`` among them), or a batch
    axis, over the ranks raise naming A8, the cost analysis A7, and the MoE
    LM in a population over model ranks A9."""
    items = {"model": "A8", "expert": "A8", "nodes_seq": "A8", "nodes_stage": "A8", "batch_seq": "A8",
             "batch": "A8", "round_cost_analysis": "A7", "model_round_cost_analysis": "A7", "moe_model": "A9"}
    for world in WORLDS:
        for got in worlds[world]:
            for key, item in items.items():
                msg = got["refusals"][key]
                assert msg is not None and f"ROADMAP queue A item {item}" in msg, (world, key, msg)
            for key in ("seq", "stage", "expert_ranks", "model_ranks", "moe_seq", "population_engine", "async_engine",
                        "save_to", "load_from", "run_checkpointer", "model_save_to"):
                assert got["refusals"][key] is None, (key, got["refusals"])
