"""Worker for ``tests/test_torch_sharded_ranks.py``: one rank of a gloo
world on the CPU, started by :func:`p2pfl_tpu_torch.parallel.launch.launch`
(not collected by pytest). It imports only the port, never JAX.

    python tests/torch_sharded_worker.py <dir> main|cross|torn

Each rank joins through ``initialize_multihost(coordinator, W, rank,
device="cpu")`` and runs one of three modes:

* ``main``: every arm of :data:`ARMS` (the small f32 flash LM, 8 nodes,
  local SGD) for 4 scheduled rounds over the ``nodes`` rank mesh, saving
  after every round into ``<dir>/lm_<arm>_w<W>``, and resumed at the same W
  from step 2; the ``model`` arm (the LM on ``{"nodes": 1, "model": W}``)
  saving after rounds 1 and 2 and resumed from step 1; both population
  engines' counterparts of the port's engine tests (the JAX engines'
  initial states from ``<dir>/sync_init.pt`` / ``<dir>/async_init_<case>.pt``);
  the collective bytes around ``save_to`` / ``load_from``; a newest step with
  rank 1's shard corrupted; a second checkpointer opened during rank 0's
  save, and one opened by rank 0 before its writer has run; and the refusals (A7 to A11);
* ``cross``: the LM arms resumed at this W from the other world's step 2
  (``<dir>/lm_<arm>_w<W'>``), and the torn root restored;
* ``torn`` (W = 2): an MLP population saves step 1, then rank 1 ``os._exit``s
  after writing its shard of step 2 and before its ``done`` file, and rank 0
  reports the save that was not committed.

Rank r saves what it saw to ``<dir>/<mode>_w<W>_r<r>.pt``. The test module
imports :data:`ARMS`, :func:`arm_data`, :func:`lm_sim` and the engine
settings to run the same arms in one process.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

NODES, SEQS, SEQ, VOCAB = 8, 4, 64, 128
LAYERS, HEADS, EMBED = 2, 2, 64
LR = 0.05
#: Four scheduled rounds: members on several ranks (out of rank order), on
#: fewer, then the other half.
SCHEDULE = [[5, 0, 6, 2], [1, 3, 0, 2], [7, 4, 2, 6], [0, 5, 3, 1]]
SAVED = 2  # the step the resumes start from
#: name -> MeshSimulation keywords (local SGD at LR; see tests/torch_multirank_worker.py).
ARMS = {
    "fedavg": dict(sgd=True),
    "scaffold": dict(algorithm="scaffold"),
    "fedadam": dict(sgd=True, server_optimizer="fedadam", server_lr=1e-2),
}
#: The population engines' counterparts of the port's engine tests.
SYNC_TRACK = dict(cohort_fraction=0.25, seed=2, batch_size=8, samples_per_node=8, hidden=(4,))
SYNC_RESUME = dict(cohort_fraction=0.5, seed=4, samples_per_node=8, hidden=(4,))
ASYNC_SMALL = dict(samples_per_node=8, feature_dim=8, num_classes=4, hidden=(8,), batch_size=4)
ASYNC_TRACK = {"lagged": ((1.0, 1.0, 2.0, 5.0), "uniform"), "flash": ((1.0, 2.0, 5.0), "flash")}
ASYNC_RESUME = dict(cohort_fraction=0.5, seed=4, speed_tiers=(1.0, 2.0, 5.0), **ASYNC_SMALL)


def async_track_spec(case: str) -> dict:
    tiers, trace = ASYNC_TRACK[case]
    return dict(cohort_fraction=0.25, seed=5, speed_tiers=tiers, trace=trace, trace_period=4,
                samples_per_node=8, feature_dim=8, num_classes=4, hidden=(8,), batch_size=8)


def arm_data(seed: int = 0):
    """Seeded tokens ``[NODES, SEQS, SEQ]``, labels, masks (node 3's last
    sequence padded, so the FedAvg weights differ) and test tokens."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, size=(NODES, SEQS, SEQ)).astype(np.int32)
    y = np.zeros((NODES, SEQS), np.int32)
    mask = np.ones((NODES, SEQS), np.float32)
    mask[3, -1] = 0.0
    xt = rng.integers(0, VOCAB, size=(4, SEQ)).astype(np.int32)
    return x, y, mask, xt


def lm_sim(arm: str, init: dict, mesh=None):
    """Arm ``arm``'s ``MeshSimulation`` of the small flash LM on ``mesh``
    (None: one process), on the CPU."""
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM
    from p2pfl_tpu_torch.optim import sgd
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    x, y, mask, xt = arm_data()
    kw = {"lr": LR, **ARMS[arm]}
    if kw.pop("sgd", False):
        kw["optimizer"] = sgd(kw["lr"])
    with torch.device("meta"):
        module = TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                               attention_kind="flash", compute_dtype=torch.float32)
    return MeshSimulation(ModelHandle({k: v.clone() for k, v in init.items()}, module), (x, y, mask),
                          test_data=(xt, None), train_set_size=len(SCHEDULE[0]), batch_size=SEQS, seed=0, task="lm",
                          mesh=mesh, device="cpu", **kw)


def run_rounds(sim, rows: list, checkpointer=None):
    return sim.run(rounds=len(rows), epochs=1, warmup=False, committee_schedule=np.asarray(rows),
                   checkpointer=checkpointer)


def whole(sim) -> dict:
    """The population state gathered whole (a copy of every leaf)."""
    from p2pfl_tpu_torch.optim import state_map

    return state_map(lambda t: t.detach().clone(), sim.state_dict())


def _stats_delta(fn) -> dict:
    from p2pfl_tpu_torch.parallel import collectives

    before = dict(collectives.STATS)
    fn()
    return {k: collectives.STATS[k] - before[k] for k in before}


def _lm_arms(out_dir: str, mesh, init: dict) -> dict:
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer

    world = mesh.world
    got = {}
    for arm in ARMS:
        ck = FLCheckpointer(os.path.join(out_dir, f"lm_{arm}_w{world}"), max_to_keep=4)
        sim = lm_sim(arm, init, mesh)
        run_rounds(sim, SCHEDULE[:SAVED], ck)
        run_rounds(sim, SCHEDULE[SAVED:])
        ck.wait()
        saves = dict(ck.last_save)
        save_stats = _stats_delta(lambda: (sim.save_to(ck), ck.wait()))  # step 4, outside the rounds
        resumed = lm_sim(arm, init, mesh)
        load_stats = _stats_delta(lambda: resumed.load_from(ck, step=SAVED))
        loads = dict(ck.last_load)
        run_rounds(resumed, SCHEDULE[SAVED:])
        got[arm] = {"uninterrupted": whole(sim), "resumed": whole(resumed), "save_stats": save_stats,
                    "load_stats": load_stats, "last_save": saves, "last_load": loads}
    return got


def _model_arm(out_dir: str, group, init: dict) -> dict:
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.parallel.mesh import Mesh

    world = torch.distributed.get_world_size()
    mesh = Mesh({"nodes": 1, "model": world}, device="cpu", group=group)
    ck = FLCheckpointer(os.path.join(out_dir, f"model_w{world}"), max_to_keep=4)
    sim = lm_sim("fedavg", init, mesh)
    run_rounds(sim, SCHEDULE[:1], ck)
    step1 = whole(sim)
    run_rounds(sim, SCHEDULE[1:2], ck)
    step2 = whole(sim)
    ck.wait()
    resumed = lm_sim("fedavg", init, mesh)
    load_stats = _stats_delta(lambda: resumed.load_from(ck, step=1))
    run_rounds(resumed, SCHEDULE[1:2])
    return {"step1": step1, "step2": step2, "resumed": whole(resumed), "load_stats": load_stats,
            "local_shapes": {k: tuple(v.shape) for k, v in sim.params_stack.items()}}


def _engines(out_dir: str, mesh) -> dict:
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.population import AsyncPopulationEngine, PopulationEngine
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    world = mesh.world
    got = {}
    with Settings.overridden(COMPUTE_DTYPE="float32"):
        eng = PopulationEngine(16, mesh=mesh, device="cpu", **SYNC_TRACK)
        lo, hi = eng.sim.slab
        eng.sim.params_stack = {k: v[lo:hi].clone() for k, v in torch.load(os.path.join(out_dir, "sync_init.pt")).items()}
        res = eng.run(3)
        got["sync_track"] = {"committees": res.committees, "test_loss": res.test_loss, "params": eng.gather_params(0),
                             "cohort_fill": eng.cohort_fill(), "rank_members": eng.sim.rank_members,
                             "gather_bytes": eng.sim.gather_bytes}
        eng.close()
        for case in ASYNC_TRACK:
            eng = AsyncPopulationEngine(24, mesh=mesh, device="cpu", **async_track_spec(case))
            eng.history = torch.load(os.path.join(out_dir, f"async_init_{case}.pt"))
            res = eng.run(6, eval_every=2, windows_per_call=3)
            got[f"async_track_{case}"] = {
                "test_loss": res.test_loss, "fills": res.fills, "close_codes": res.close_codes,
                "lag_sums": res.lag_sums, "params": eng.global_params(), "window_fill": eng.window_fill(),
                "rank_members": eng.rank_members, "gather_bytes": eng.gather_bytes}
            eng.close()
    # Resumes: kill after a prefix, restore, finish (counterparts of the port's checkpoint tests).
    ck = FLCheckpointer(os.path.join(out_dir, f"sync_w{world}"))
    with PopulationEngine(8, mesh=mesh, device="cpu", **SYNC_RESUME) as victim:
        victim.run(2)
        assert victim.save_to(ck)
        victim.run(1)
    with PopulationEngine(8, mesh=mesh, device="cpu", **SYNC_RESUME) as healed:
        restored = healed.load_from(ck)
        healed.run(1)
        got["sync_resume"] = {"restored": restored, "hash": canonical_params_hash(healed.gather_params(0)),
                              "cohort_fill": healed.cohort_fill(), "completed": healed.completed_rounds}
    ck = FLCheckpointer(os.path.join(out_dir, f"async_w{world}"))
    with AsyncPopulationEngine(12, mesh=mesh, device="cpu", **ASYNC_RESUME) as victim:
        victim.run(4, eval_every=10)
        assert victim.save_to(ck)
        victim.run(1, eval_every=10)  # the ring moves on in place; the saved copy must not
        ck.wait()
        saves = dict(ck.last_save)
    with AsyncPopulationEngine(12, mesh=mesh, device="cpu", **ASYNC_RESUME) as healed:
        restored = healed.load_from(ck)
        healed.run(3, eval_every=10)
        got["async_resume"] = {"restored": restored, "hash": canonical_params_hash(healed.global_params()),
                               "window_fill": healed.window_fill(), "last_save": saves,
                               "rank_members": healed.rank_members, "gather_bytes": healed.gather_bytes}
    with AsyncPopulationEngine(12, mesh=mesh, device="cpu", **{**ASYNC_RESUME, "seed": 5}) as wrong:
        try:
            wrong.load_from(ck)
            got["async_wrong_seed"] = None
        except ValueError as e:
            got["async_wrong_seed"] = str(e)
    return got


def _mlp_sim(mesh, nodes: int = 8):
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    parts = synthetic_mnist(n_train=32 * nodes, n_test=32).generate_partitions(nodes, RandomIIDPartitionStrategy)
    return MeshSimulation(mlp_model(seed=0, device="cpu"), parts, train_set_size=2, batch_size=16, seed=1, mesh=mesh,
                          device="cpu")


def _corrupted(out_dir: str, mesh) -> dict:
    """Steps 1-3 saved; rank 1's shard of step 3 overwritten; every rank
    restores with ``step=None``."""
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.parallel import collectives

    root = os.path.join(out_dir, f"corrupt_w{mesh.world}")
    ck = FLCheckpointer(root, max_to_keep=5)
    sim = _mlp_sim(mesh)
    sim.run(3, warmup=False, checkpointer=ck)
    ck.wait()
    collectives.all_agree(True, mesh.group)  # every rank's save has landed
    if mesh.rank == 0:
        with open(os.path.join(root, "3", f"shard-00001-of-{mesh.world:05d}.pt"), "r+b") as f:
            f.write(b"\0" * 64)
    collectives.all_agree(True, mesh.group)
    healed = _mlp_sim(mesh)
    return {"restored": healed.load_from(FLCheckpointer(root, max_to_keep=5)), "steps": ck.all_steps()}


def _concurrent_open(out_dir: str, mesh) -> dict:
    """Rank 0's save holds before its commit until every rank has opened a
    second checkpointer on the root during it; the stage survives every
    open, and a stale stage is swept by rank 0's."""
    from p2pfl_tpu_torch.management import checkpoint
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.parallel import collectives

    root = os.path.join(out_dir, f"open_w{mesh.world}")
    ck = FLCheckpointer(root)
    stale = os.path.join(root, ".tmp-99-stale")
    if mesh.rank == 0:
        os.makedirs(stale)
    collectives.all_agree(True, mesh.group)
    go = os.path.join(root, "go")
    if mesh.rank == 0:
        original = ck._await_ranks

        def held(stage, world, step):
            deadline = time.monotonic() + 60
            while not all(os.path.exists(f"{go}-{r}") for r in range(world)) and time.monotonic() < deadline:
                time.sleep(0.01)
            return original(stage, world, step)

        ck._await_ranks = held
    sim = _mlp_sim(mesh)
    sim.save_to(ck)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not any(n.startswith(".tmp-0-") and os.path.exists(
            os.path.join(root, n, f"done-{mesh.rank}")) for n in os.listdir(root)):
        time.sleep(0.01)
    stages = [n for n in os.listdir(root) if n.startswith(".tmp-0-")]
    FLCheckpointer(root)  # a second open during the save
    kept = [n for n in stages if os.path.isdir(os.path.join(root, n))]
    with checkpoint._LIVE_LOCK:
        live = len(checkpoint._LIVE_STAGES)
    open(f"{go}-{mesh.rank}", "w").close()
    ck.wait()
    return {"stages": stages, "kept": kept, "live": live, "stale_left": os.path.exists(stale),
            "steps": ck.all_steps()}


def _open_before_writer(out_dir: str, mesh) -> dict:
    """Rank 0's writer is held before it runs; once every other rank's
    shard is in the stage, rank 0 opens a second checkpointer on the root
    (its sweep runs), then lets its writer go: the stage survives and the
    step commits."""
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer

    root = os.path.join(out_dir, f"early_w{mesh.world}")
    ck = FLCheckpointer(root)
    go = threading.Event()
    if mesh.rank == 0:
        original = ck._write_sharded_step

        def held(*args):
            go.wait(60)
            original(*args)

        ck._write_sharded_step = held
    sim = _mlp_sim(mesh)
    sim.save_to(ck)
    got = {}
    if mesh.rank == 0:
        deadline = time.monotonic() + 60
        others = [f"done-{r}" for r in range(1, mesh.world)]
        while time.monotonic() < deadline and not any(
                n.startswith(".tmp-0-") and all(os.path.exists(os.path.join(root, n, d)) for d in others)
                for n in os.listdir(root)):
            time.sleep(0.01)
        stages = [n for n in os.listdir(root) if n.startswith(".tmp-0-")]
        FLCheckpointer(root)  # rank 0's sweep, before its own writer has run
        got = {"stages": stages, "kept": [n for n in stages if os.path.isdir(os.path.join(root, n))]}
        go.set()
    ck.wait()
    got["steps"] = ck.all_steps()
    return got


def _refusals(mesh) -> dict:
    """Each refusal's message, or None where nothing raised."""
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.models.moe import moe_lm_model
    from p2pfl_tpu_torch.parallel.mesh import Mesh
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
    from p2pfl_tpu_torch.population import AsyncPopulationEngine, EngineSupervisor, PopulationEngine

    world = mesh.world
    model = Mesh({"nodes": 1, "model": world}, device="cpu", group=mesh.group)
    got = {}

    def note(key, fn):
        try:
            fn()
            got[key] = None
        except NotImplementedError as e:
            got[key] = str(e)

    sup = EngineSupervisor(lambda **kw: PopulationEngine(8, mesh=mesh, device="cpu", **kw),
                           FLCheckpointer(os.path.join(sys.argv[1], f"sup_w{world}")), backoff_s=0.0)
    note("supervisor", lambda: sup.run(1))
    note("engine_model", lambda: PopulationEngine(8, mesh=model, device="cpu"))
    note("async_engine_model", lambda: AsyncPopulationEngine(8, mesh=model, device="cpu"))
    note("round_cost_analysis", lambda: _mlp_sim(mesh).round_cost_analysis())
    note("nodes_model", lambda: Mesh({"nodes": world, "model": 2}, device="cpu", group=mesh.group))
    moe_lm = moe_lm_model(0, 8, 16, 2, 2, 16, 2, device="cpu")
    toks = np.zeros((4, 2, 8), np.int32)
    note("moe_model", lambda: MeshSimulation(moe_lm, (toks, np.zeros((4, 2), np.int32), np.ones((4, 2), np.float32)),
                                             test_data=(toks[0], None), train_set_size=2, batch_size=2, seed=1,
                                             task="lm", mesh=model, device="cpu"))
    return got


def _torn(out_dir: str, mesh) -> dict:
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer

    ck = FLCheckpointer(os.path.join(out_dir, "torn"))
    ck.commit_timeout_s = 10.0
    sim = _mlp_sim(mesh)
    sim.run(1, warmup=False, checkpointer=ck)
    ck.wait()
    if mesh.rank == 1:  # after its shard of the next step, before its done file
        def die(*_args):
            os._exit(3)

        ck._mark_done = die
    sim.run(1, warmup=False, checkpointer=ck)
    try:
        ck.wait()
        return {"error": None}
    except RuntimeError as e:
        return {"error": str(e), "steps": ck.all_steps()}


def main() -> int:
    torch.set_num_threads(1)
    out_dir, mode = sys.argv[1], sys.argv[2]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from p2pfl_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown_multihost

    initialize_multihost(f"127.0.0.1:{os.environ['MASTER_PORT']}", world, rank, device="cpu")
    mesh = make_mesh(devices=["cpu"])
    saved = {"rank": rank, "world": world}
    init = torch.load(os.path.join(out_dir, "init.pt"))
    if mode == "main":
        saved["lm"] = _lm_arms(out_dir, mesh, init)
        saved["model"] = _model_arm(out_dir, mesh.group, init)
        saved["engines"] = _engines(out_dir, mesh)
        saved["corrupted"] = _corrupted(out_dir, mesh)
        saved["concurrent_open"] = _concurrent_open(out_dir, mesh)
        saved["open_before_writer"] = _open_before_writer(out_dir, mesh)
        saved["refusals"] = _refusals(mesh)
    elif mode == "cross":
        other = 4 if world == 2 else 2
        saved["lm"] = {}
        for arm in ARMS:
            from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer

            sim = lm_sim(arm, init, mesh)
            sim.load_from(FLCheckpointer(os.path.join(out_dir, f"lm_{arm}_w{other}"), max_to_keep=4), step=SAVED)
            run_rounds(sim, SCHEDULE[SAVED:])
            saved["lm"][arm] = whole(sim)
        if world == 2:
            from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer

            saved["torn_restored"] = _mlp_sim(mesh).load_from(FLCheckpointer(os.path.join(out_dir, "torn")))
    else:
        saved["torn"] = _torn(out_dir, mesh)
    torch.save(saved, os.path.join(out_dir, f"{mode}_w{world}_r{rank}.pt"))
    shutdown_multihost()
    print(f"WORKER_DONE rank={rank} world={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
