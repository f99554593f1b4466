"""Sharded checkpoints and both population engines over ranks, on the CPU
with gloo.

Worlds of ``tests/torch_sharded_worker.py`` run side by side under the
port's ``launch``, each with its own deadline: first ``main`` at W = 2 and
W = 4 and ``torn`` at W = 2, then ``cross`` at W = 2 and W = 4. Meanwhile
this process computes the references: the JAX package's ``MeshSimulation``
on its 8-device CPU mesh and its engines, and the port's one-process runs on
one CPU thread, as every rank runs (the CPU's matrix products split their
sums by the thread count). The cases:

* the small f32 flash LM (2 layers, width 64, sequence 64, 8 nodes, local
  SGD; FedAvg, SCAFFOLD, ``server_optimizer="fedadam"``): saved after every
  round over W ranks, resumed from round 2 of 4 at W' in {1, 2, 4}, bit-equal
  to the one-process uninterrupted run, which is within 1e-5 of the JAX
  package's;
* the shard layout: each rank's file holds only its rows, the replicated
  leaves are written once, the bytes add up to the one-process step's, and
  ``save_to`` / ``load_from`` gather nothing;
* torn and stale steps: a rank that dies before its ``done`` file leaves no
  visible step, a corrupted shard makes every rank fall back to the same
  older step, and a second checkpointer opened during a save sweeps no
  stage of it;
* the ``model`` arm: resumed at the same W bit-equal to uninterrupted, and a
  W-rank step restored in one process equal to the saver's gathered state;
* both engines over W ranks, against one process (bit for bit) and the JAX
  engines (1e-5), checkpoints included;
* the refusals that stay: A7, A8, A9, A10 and A11.
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

import torch_sharded_worker as worker
from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle
from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from p2pfl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation
from p2pfl_tpu.population import AsyncPopulationEngine as JaxAsyncPopulationEngine
from p2pfl_tpu.population import PopulationEngine as JaxPopulationEngine
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
from p2pfl_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from p2pfl_tpu_torch.parallel.launch import launch
from p2pfl_tpu_torch.parallel.mesh import make_mesh
from p2pfl_tpu_torch.population import AsyncPopulationEngine, PopulationEngine
from p2pfl_tpu_torch.population.sharding import part_range, recut
from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
DEADLINE_S = 300.0


def _launch_all(out_dir, jobs):
    """Run every ``(mode, W)`` world at once; ``{(mode, W): [(rc, output), ...]}``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    env.pop("JAX_PLATFORMS", None)
    runs = {}

    def start(mode, world):
        runs[mode, world] = launch([sys.executable, os.path.join(ROOT, "tests", "torch_sharded_worker.py"),
                                    str(out_dir), mode], world, timeout_s=DEADLINE_S, env=env, cwd=ROOT)

    threads = [threading.Thread(target=start, args=job) for job in jobs]
    for t in threads:
        t.start()
    return threads, runs


def _load(out_dir, mode, world):
    return [torch.load(out_dir / f"{mode}_w{world}_r{r}.pt", weights_only=False) for r in range(world)]


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _jax_lm(params, module, arm):
    x, y, mask, xt = worker.arm_data()
    kw = {"lr": worker.LR, **worker.ARMS[arm]}
    if kw.pop("sgd", False):
        kw["optimizer"] = optax.sgd(kw["lr"])
    jsim = JaxMeshSimulation(JaxModelHandle(params=params, apply_fn=module.apply, model_def=module), (x, y, mask),
                             test_data=(xt, None), train_set_size=len(worker.SCHEDULE[0]), batch_size=worker.SEQS,
                             seed=0, task="lm", mesh=jax_make_mesh(), **kw)
    res = jsim.run(rounds=len(worker.SCHEDULE), epochs=1, warmup=False,
                   committee_schedule=np.asarray(worker.SCHEDULE))
    return {"test_loss": res.test_loss, "node0": jax.tree.map(lambda a: np.asarray(a[0]), jsim.params_stack)}


def _port_lm(init, arm):
    sim = worker.lm_sim(arm, init)
    a = worker.run_rounds(sim, worker.SCHEDULE[:worker.SAVED])
    b = worker.run_rounds(sim, worker.SCHEDULE[worker.SAVED:])
    return {"state": worker.whole(sim), "test_loss": a.test_loss + b.test_loss}


def _port_engines(out_dir):
    out = {}
    with Settings.overridden(COMPUTE_DTYPE="float32"):
        with PopulationEngine(16, device="cpu", **worker.SYNC_TRACK) as eng:
            eng.sim.params_stack = torch.load(out_dir / "sync_init.pt")
            res = eng.run(3)
            out["sync_track"] = {"test_loss": res.test_loss, "params": eng.gather_params(0),
                                 "cohort_fill": eng.cohort_fill()}
        for case in worker.ASYNC_TRACK:
            with AsyncPopulationEngine(24, device="cpu", **worker.async_track_spec(case)) as eng:
                eng.history = torch.load(out_dir / f"async_init_{case}.pt")
                res = eng.run(6, eval_every=2, windows_per_call=3)
                out[f"async_track_{case}"] = {"test_loss": res.test_loss, "params": eng.global_params(),
                                              "window_fill": eng.window_fill(), "schedule": res.schedule}
    with PopulationEngine(8, device="cpu", **worker.SYNC_RESUME) as ref:
        ref.run(3)
        out["sync_resume"] = {"hash": canonical_params_hash(ref.gather_params(0)), "cohort_fill": ref.cohort_fill()}
    with AsyncPopulationEngine(12, device="cpu", **worker.ASYNC_RESUME) as ref:
        ref.run(7, eval_every=10)
        out["async_resume"] = {"hash": canonical_params_hash(ref.global_params()), "window_fill": ref.window_fill()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's saved results and this process's references."""
    out_dir = tmp_path_factory.mktemp("sharded")
    module = JaxTransformerLM(vocab_size=worker.VOCAB, num_layers=worker.LAYERS, num_heads=worker.HEADS,
                              embed_dim=worker.EMBED, attention_kind="flash", compute_dtype=jnp.float32)
    params = module.init(jax.random.key(0), jnp.zeros((1, worker.SEQ), jnp.int32))
    init = flax_to_torch(params, device="cpu")
    torch.save(init, out_dir / "init.pt")
    jax_engines = {}
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        jeng = JaxPopulationEngine(16, **worker.SYNC_TRACK)
        torch.save(flax_to_torch(jax.tree.map(np.asarray, jeng.sim.params_stack), device="cpu"),
                   out_dir / "sync_init.pt")
        jax_engines["sync_track"] = jeng
        for case in worker.ASYNC_TRACK:
            jeng = JaxAsyncPopulationEngine(24, **worker.async_track_spec(case))
            torch.save(flax_to_torch(jax.tree.map(np.asarray, jeng.history), device="cpu"),
                       out_dir / f"async_init_{case}.pt")
            jax_engines[f"async_track_{case}"] = jeng
    threads, launched = _launch_all(out_dir, [("main", 2), ("main", 4), ("torn", 2)])
    got = {"dir": out_dir, "jax": {}}
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        for name, jeng in jax_engines.items():
            res = jeng.run(3) if name == "sync_track" else jeng.run(6, eval_every=2, windows_per_call=3)
            ring = jeng.sim.params_stack if name == "sync_track" else jeng.history
            got["jax"][name] = {"test_loss": res.test_loss, "res": res, "cohort_fill": (
                jeng.cohort_fill() if name == "sync_track" else jeng.window_fill()),
                "params": flax_to_torch(jax.tree.map(lambda a: np.asarray(a[0]), ring), device="cpu")}
            jeng.close()
    got["jax_lm"] = {arm: _jax_lm(params, module, arm) for arm in worker.ARMS}
    got["one"] = _one_thread(lambda: {arm: _port_lm(init, arm) for arm in worker.ARMS})
    got["engines"] = _one_thread(lambda: _port_engines(out_dir))
    for t in threads:
        t.join()
    for (mode, world), results in launched.items():
        for rank, (rc, out) in enumerate(results):
            if mode == "torn" and rank == 1:
                assert rc == 3, f"torn rank 1 exited {rc}:\n{out[-4000:]}"
                continue
            assert rc == 0, f"{mode} world {world} rank {rank} exited {rc}:\n{out[-4000:]}"
            assert f"WORKER_DONE rank={rank} world={world}" in out, out[-2000:]
    got["main"] = {w: _load(out_dir, "main", w) for w in WORLDS}
    got["torn"] = torch.load(out_dir / "torn_w2_r0.pt", weights_only=False)
    got["torn_steps"] = sorted(os.listdir(out_dir / "torn"))
    threads, launched = _launch_all(out_dir, [("cross", 2), ("cross", 4)])

    def one_process_resumes():
        resumed = {}
        for w in WORLDS:
            for arm in worker.ARMS:
                sim = worker.lm_sim(arm, init)
                sim.load_from(FLCheckpointer(str(out_dir / f"lm_{arm}_w{w}"), max_to_keep=4), step=worker.SAVED)
                worker.run_rounds(sim, worker.SCHEDULE[worker.SAVED:])
                resumed[arm, w] = worker.whole(sim)
            sim = worker.lm_sim("fedavg", init)
            sim.load_from(FLCheckpointer(str(out_dir / f"model_w{w}"), max_to_keep=4), step=1)
            resumed["model", w] = worker.whole(sim)
        return resumed

    got["one_resumed"] = _one_thread(one_process_resumes)
    for t in threads:
        t.join()
    for (mode, world), results in launched.items():
        for rank, (rc, out) in enumerate(results):
            assert rc == 0, f"{mode} world {world} rank {rank} exited {rc}:\n{out[-4000:]}"
    got["cross"] = {w: _load(out_dir, "cross", w) for w in WORLDS}
    return got


def _assert_state_equal(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        g, w = got[key], want[key]
        if w is None:
            assert g is None, (what, key)
        elif isinstance(w, torch.Tensor):
            assert torch.equal(g, w), (what, key)
        elif isinstance(w, dict):
            _assert_state_equal(g, w, (what, key))
        else:  # an optimizer state dataclass
            _assert_state_equal(vars(g), vars(w), (what, key))


def _nodes(state):
    return {k: v[:worker.NODES] for k, v in state["params_stack"].items()}


# --- the LM arms ----------------------------------------------------------------------------


@pytest.mark.parametrize("resume_at", (1, 2, 4))
@pytest.mark.parametrize("saved_at", WORLDS)
@pytest.mark.parametrize("arm", sorted(worker.ARMS))
def test_lm_resume_at_any_world_size_is_bit_equal_to_one_process(arm, saved_at, resume_at, runs):
    want = runs["one"][arm]["state"]
    if resume_at == 1:
        _assert_state_equal(runs["one_resumed"][arm, saved_at], want, (arm, saved_at, 1))
        return
    ranks = runs["main"][resume_at] if resume_at == saved_at else runs["cross"][resume_at]
    for got in ranks:
        state = got["lm"][arm]["resumed"] if resume_at == saved_at else got["lm"][arm]
        _assert_state_equal(state, want, (arm, saved_at, resume_at, got["rank"]))
        if resume_at == saved_at:  # the uninterrupted run over ranks too
            _assert_state_equal(got["lm"][arm]["uninterrupted"], want, (arm, saved_at, "uninterrupted"))


@pytest.mark.parametrize("arm", sorted(worker.ARMS))
def test_lm_one_process_run_matches_the_jax_mesh_simulation(arm, runs):
    ref = runs["jax_lm"][arm]
    got = runs["one"][arm]
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], atol=1e-5, rtol=0)
    node0 = {k: v[0] for k, v in got["state"]["params_stack"].items()}
    diffs = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b))), torch_to_flax(node0), ref["node0"])
    assert max(jax.tree.leaves(diffs)) < 1e-5, diffs


# --- the shard layout ------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_writes_its_rows_and_rank_0_the_replicated_leaves_once(world, runs, tmp_path):
    out = runs["dir"]
    for arm in worker.ARMS:
        step = out / f"lm_{arm}_w{world}" / str(worker.SAVED)
        files = sorted(os.listdir(step))
        assert files == ["_CHECKPOINT_METADATA", "meta.json", "replicated.pt"] + [
            f"shard-{r:05d}-of-{world:05d}.pt" for r in range(world)], files
        rank0 = runs["main"][world][0]["lm"][arm]
        shards = [torch.load(step / f"shard-{r:05d}-of-{world:05d}.pt") for r in range(world)]
        replicated = torch.load(step / "replicated.pt")
        per = worker.NODES // world
        for r, shard in enumerate(shards):
            assert set(shard) and all(k.split("/")[0] in ("params_stack", "opt_stack", "c_stack") for k in shard)
            for k, v in shard.items():
                assert v.shape[0] == per, (arm, r, k)
        assert all(k.startswith("c_global/") for k in replicated), sorted(replicated)[:4]
        assert bool(replicated) == (arm != "fedavg")
        # The one-process layout of the same step: the bytes add up.
        sim = worker.lm_sim(arm, torch.load(out / "init.pt"))
        sim.load_from(FLCheckpointer(str(out / f"lm_{arm}_w{world}"), max_to_keep=4), step=worker.SAVED)
        one = FLCheckpointer(str(tmp_path / arm))
        sim.save_to(one)
        one.wait()
        flat = torch.load(tmp_path / arm / str(worker.SAVED) / "state.pt")
        total = sum(v.numel() * v.element_size() for part in (*shards, replicated) for v in part.values())
        assert total == sum(v.numel() * v.element_size() for v in flat.values()) == one.last_save["tensor_bytes"]
        assert all(set(shard) == set(shards[0]) for shard in shards)
        assert sorted(flat) == sorted([*shards[0], *replicated])
        for k, v in flat.items():
            parts = [s[k] for s in shards] if k in shards[0] else [replicated[k]]
            assert torch.equal(torch.cat(parts) if len(parts) > 1 else parts[0], v), (arm, k)
        sizes = [g["lm"][arm]["last_save"] for g in runs["main"][world]]
        assert [s["tensor_bytes"] for s in sizes] == [sum(v.numel() * v.element_size() for v in s.values())
                                                       for s in shards]
        assert sizes[0]["replicated_tensor_bytes"] == sum(v.numel() * v.element_size() for v in replicated.values())
        assert all(s["step"] == worker.SAVED and s["commit_wait_ms"] >= 0 for s in sizes)
        assert rank0["last_load"]["files"] == ["replicated.pt", f"shard-00000-of-{world:05d}.pt"]


@pytest.mark.parametrize("world", WORLDS)
def test_save_and_load_move_no_population_rows(world, runs):
    for got in runs["main"][world]:
        for arm in worker.ARMS:
            for key in ("save_stats", "load_stats"):
                stats = got["lm"][arm][key]
                assert stats["all_gather_bytes"] == 0 and stats["gather_dim_bytes"] == 0, (arm, key, stats)
        assert got["model"]["load_stats"]["gather_dim_bytes"] == 0
        assert got["model"]["load_stats"]["all_gather_bytes"] == 0


def test_a_rank_that_dies_before_its_done_file_leaves_no_visible_step(runs):
    torn = runs["torn"]["torn"]
    assert torn["error"] is not None and "wrote no shard" in torn["error"], torn
    assert torn["steps"] == [1]
    assert runs["torn_steps"] == ["1"]  # the stage of step 2 is gone, its step never appeared
    assert [got["torn_restored"] for got in runs["cross"][2]] == [1, 1]


@pytest.mark.parametrize("world", WORLDS)
def test_a_corrupted_shard_makes_every_rank_fall_back_to_the_same_step(world, runs):
    for got in runs["main"][world]:
        assert got["corrupted"]["steps"] == [1, 2, 3]
        assert got["corrupted"]["restored"] == 2, got["corrupted"]


@pytest.mark.parametrize("world", WORLDS)
def test_a_checkpointer_opened_during_a_save_sweeps_none_of_its_stage(world, runs):
    for got in runs["main"][world]:
        opened = got["concurrent_open"]
        assert len(opened["stages"]) == 1 and opened["kept"] == opened["stages"], opened
        assert opened["live"] >= 1 and opened["steps"] == [0], opened
    assert runs["main"][world][0]["concurrent_open"]["stale_left"] is False


@pytest.mark.parametrize("world", WORLDS)
def test_a_checkpointer_opened_before_rank_0s_writer_runs_sweeps_no_stage(world, runs):
    ranks = runs["main"][world]
    early = ranks[0]["open_before_writer"]
    assert len(early["stages"]) == 1 and early["kept"] == early["stages"], early
    assert [got["open_before_writer"]["steps"] for got in ranks] == [[0]] * world


# --- the model arm ------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_model_arm_resumes_bit_equal_and_restores_in_one_process(world, runs):
    ranks = runs["main"][world]
    for got in ranks:
        model = got["model"]
        _assert_state_equal(model["resumed"], ranks[0]["model"]["step2"], (world, got["rank"]))
        _assert_state_equal(model["step2"], ranks[0]["model"]["step2"], (world, got["rank"], "step2"))
    _assert_state_equal(runs["one_resumed"]["model", world], ranks[0]["model"]["step1"], (world, "one process"))
    shapes = ranks[0]["model"]["local_shapes"]
    assert shapes["lm_head.weight"][1] == worker.VOCAB // world  # the rank held a slice of the split leaves


# --- both engines over ranks ----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_engine_rounds_over_ranks_track_one_process_and_the_jax_package(world, runs):
    one, ref = runs["engines"]["sync_track"], runs["jax"]["sync_track"]
    for got in runs["main"][world]:
        eng = got["engines"]["sync_track"]
        np.testing.assert_array_equal(eng["committees"], np.asarray(ref["res"].committees))
        assert eng["test_loss"] == one["test_loss"]
        np.testing.assert_allclose(eng["test_loss"], ref["test_loss"], atol=1e-5)
        for k, v in one["params"].items():
            np.testing.assert_array_equal(eng["params"][k], v, err_msg=k)
            np.testing.assert_allclose(eng["params"][k], ref["params"][k].numpy(), atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(eng["cohort_fill"], ref["cohort_fill"])
        per = 16 // world
        assert eng["rank_members"] == [[sum(n // per == r for n in row) for r in range(world)]
                                       for row in np.asarray(eng["committees"])]
        assert all(b > 0 for b in eng["gather_bytes"])


@pytest.mark.parametrize("world", WORLDS)
def test_engine_checkpoint_resume_over_ranks_replays_cohort_accounting(world, runs):
    one = runs["engines"]["sync_resume"]
    for got in runs["main"][world]:
        eng = got["engines"]["sync_resume"]
        assert eng["restored"] == 2 and eng["completed"] == 3
        assert eng["hash"] == one["hash"]
        np.testing.assert_allclose(eng["cohort_fill"], one["cohort_fill"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(worker.ASYNC_TRACK))
def test_engine_windows_over_ranks_track_one_process_and_the_jax_package(case, world, runs):
    name = f"async_track_{case}"
    one, ref = runs["engines"][name], runs["jax"][name]
    for got in runs["main"][world]:
        eng = got["engines"][name]
        for attr in ("fills", "close_codes", "lag_sums"):
            np.testing.assert_array_equal(eng[attr], getattr(ref["res"], attr), err_msg=attr)
        assert eng["test_loss"] == one["test_loss"]
        np.testing.assert_allclose(eng["test_loss"], ref["test_loss"], atol=1e-5)
        for k, v in one["params"].items():
            np.testing.assert_array_equal(eng["params"][k], v, err_msg=k)
            np.testing.assert_allclose(eng["params"][k], ref["params"][k].numpy(), atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(eng["window_fill"], ref["cohort_fill"])
        per = 24 // world
        sched = one["schedule"]
        want = [[sum(int(n) // per == r for n in sched.members[w][sched.present[w]]) for r in range(world)]
                for w in range(sched.windows)]
        assert eng["rank_members"] == want
        assert [b > 0 for b in eng["gather_bytes"]] == [bool(f) for f in eng["fills"]]


@pytest.mark.parametrize("world", WORLDS)
def test_async_checkpoint_resume_over_ranks_replays_window_stream(world, runs):
    one = runs["engines"]["async_resume"]
    for got in runs["main"][world]:
        eng = got["engines"]["async_resume"]
        assert eng["restored"] == 4
        assert eng["hash"] == one["hash"]
        np.testing.assert_allclose(eng["window_fill"], one["window_fill"])
        assert "seed" in got["engines"]["async_wrong_seed"]
        # The ring is written once (rank 0's replicated file); SGD keeps no optimizer rows.
        assert eng["last_save"]["tensor_bytes"] == 0
    assert runs["main"][world][0]["engines"]["async_resume"]["last_save"]["replicated_tensor_bytes"] > 0


# --- refusals, and the pieces on one process ------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_what_ranks_do_not_run_yet_raises_naming_its_roadmap_item(world, runs):
    items = {"supervisor": "A10", "engine_model": "A11", "async_engine_model": "A11", "round_cost_analysis": "A7",
             "nodes_model": "A8", "moe_model": "A9"}
    for got in runs["main"][world]:
        for key, item in items.items():
            msg = got["refusals"][key]
            assert msg is not None and f"ROADMAP queue A item {item}" in msg, (world, key, msg)


def test_recut_assembles_any_part_from_the_saved_parts():
    whole = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for saved in (1, 2, 4):
        pieces = [([part_range(8, r, saved), (0, 6)], whole[slice(*part_range(8, r, saved))]) for r in range(saved)]
        for want in (1, 2, 4, 8):
            for r in range(want):
                rows = part_range(8, r, want)
                np.testing.assert_array_equal(recut(pieces, [rows, (0, 6)], "x"), whole[slice(*rows)])
        cols = [(0, 8), part_range(6, 1, 2)]  # a slice on the other dimension
        np.testing.assert_array_equal(recut(pieces, cols, "x"), whole[:, 3:])
    with pytest.raises(ValueError, match="do not cover"):
        recut([([(0, 4), (0, 6)], whole[:4])], [(0, 8), (0, 6)], "x")


def test_a_step_of_another_padded_size_raises_naming_both(tmp_path):
    kw = dict(cohort_fraction=0.5, seed=1, device="cpu", samples_per_node=8, hidden=(4,))
    ck = FLCheckpointer(str(tmp_path))
    with PopulationEngine(6, **kw) as eng:
        eng.run(1)
        eng.save_to(ck)
    with PopulationEngine(6, mesh=make_mesh((4, 1), devices=["cpu"]), **kw) as padded:
        with pytest.raises(ValueError, match="padded to 6 nodes.* to 8"):
            padded.load_from(ck)
