"""The port's sync population engine (``p2pfl_tpu_torch/population/engine.py``,
``sharding.py``, the label skew of ``scenarios.py``) and the one-device mesh
helpers (``parallel/mesh.py``) against the JAX package's on the CPU.

Host-side pieces (the data, names, the Byzantine mask, the speed tiers, the
cohort schedules, the partition rules' selections) must equal the JAX
package's bit for bit. The rounds differ only in f32 sum order once the JAX
engine's initial params are carried into the port's (``models/convert.py``)
and a batch is all of a node's samples. The engine's counterparts of the
JAX package's ``test_population.py`` cases run on the port alone.
"""

import jax
import numpy as np
import pytest
import torch

from p2pfl_tpu.population import PopulationEngine as JaxPopulationEngine
from p2pfl_tpu.population.engine import population_data as jax_population_data
from p2pfl_tpu.population.engine import vnode_names as jax_vnode_names
from p2pfl_tpu.population.scenarios import dirichlet_label_counts as jax_dirichlet_label_counts
from p2pfl_tpu.population.sharding import match_partition_rules as jax_match_partition_rules
from p2pfl_tpu.population.sharding import population_partition_rules as jax_population_partition_rules
from p2pfl_tpu.population.sharding import tree_path_names as jax_tree_path_names
from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
from p2pfl_tpu_torch.models.convert import flax_path, flax_to_torch
from p2pfl_tpu_torch.parallel.mesh import (
    NamedSharding,
    PartitionSpec,
    initialize_multihost,
    make_mesh,
    population_sharding,
    replicated,
)
from p2pfl_tpu_torch.population import (
    PopulationEngine,
    make_shard_and_gather_fns,
    match_partition_rules,
    population_data,
    population_partition_rules,
    tree_path_names,
    vnode_names,
)
from p2pfl_tpu_torch.population.scenarios import dirichlet_label_counts
from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

SMALL = dict(samples_per_node=8, hidden=(4,))


# --- host-side equality ----------------------------------------------------------------


def test_dirichlet_label_counts_exact_sizes_and_skew():
    rng = np.random.default_rng(11)
    n, s, c = 64, 40, 10
    skewed = dirichlet_label_counts(rng, n, s, c, alpha=0.05)  # every node nearly single-class
    assert skewed.shape == (n, c)
    assert (skewed.sum(axis=1) == s).all()
    assert (skewed.max(axis=1) / s).mean() > 0.7
    flat = dirichlet_label_counts(rng, n, s, c, alpha=1000.0)  # no dominant class anywhere
    assert (flat.sum(axis=1) == s).all()
    assert (flat.max(axis=1) / s).mean() < 0.25
    for alpha in (0.05, 0.3, 1000.0):
        np.testing.assert_array_equal(dirichlet_label_counts(np.random.default_rng(3), n, s, c, alpha),
                                      jax_dirichlet_label_counts(np.random.default_rng(3), n, s, c, alpha))


@pytest.mark.parametrize("alpha", [None, 0.3])
def test_population_data_equals_the_jax_package(alpha):
    got = population_data(7, 40, samples_per_node=12, feature_dim=6, num_classes=5, dirichlet_alpha=alpha,
                          eval_samples=32)
    want = jax_population_data(7, 40, samples_per_node=12, feature_dim=6, num_classes=5, dirichlet_alpha=alpha,
                               eval_samples=32)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 7, 100_000, 1_234_567])
def test_vnode_names_equal_the_jax_package(n):
    if n > 100_000:
        assert vnode_names(n)[-1] == jax_vnode_names(n)[-1] == "vnode/1234566"
    else:
        assert vnode_names(n) == jax_vnode_names(n)


@pytest.mark.parametrize("kw", [dict(cohort_fraction=0.25), dict(cohort_fraction=0.5, churn_rate=0.2, cohort_min=2)])
def test_engine_masks_tiers_and_schedules_equal_the_jax_package(kw):
    spec = dict(seed=6, byzantine_fraction=0.25, speed_tiers=(1.0, 2.0, 5.0), dirichlet_alpha=0.5, **SMALL, **kw)
    with JaxPopulationEngine(16, **spec) as ref, PopulationEngine(16, device="cpu", **spec) as eng:
        assert eng.names == ref.names and eng.cohort_k == ref.cohort_k
        np.testing.assert_array_equal(eng.sim._byz.numpy(), np.asarray(ref.sim._byz)[:16])
        np.testing.assert_array_equal(eng.sim.node_speed, np.asarray(ref.sim.node_speed)[:16])
        np.testing.assert_array_equal(eng.schedule(5), ref.schedule(5))
        np.testing.assert_array_equal(eng.sim.x.numpy(), np.asarray(ref.sim.x)[:16])


def test_engine_rounds_track_the_jax_package():
    """The JAX engine's initial params carried into the port's; three
    cohort-sampled rounds (one batch a node, f32 compute on both sides)
    agree within 1e-5."""
    from p2pfl_tpu.config import Settings as JaxSettings
    from p2pfl_tpu_torch.config import Settings

    spec = dict(cohort_fraction=0.25, seed=2, batch_size=8, **SMALL)
    with Settings.overridden(COMPUTE_DTYPE="float32"), JaxSettings.overridden(COMPUTE_DTYPE="float32"), \
            JaxPopulationEngine(16, **spec) as ref, PopulationEngine(16, device="cpu", **spec) as eng:
        eng.sim.params_stack = flax_to_torch(jax.tree.map(np.asarray, ref.sim.params_stack), device="cpu")
        jres, res = ref.run(3), eng.run(3)
        np.testing.assert_array_equal(res.committees, np.asarray(jres.committees))
        np.testing.assert_allclose(res.test_loss, jres.test_loss, atol=1e-5)
        want = flax_to_torch(jax.tree.map(lambda a: np.asarray(a[0]), ref.sim.params_stack), device="cpu")
        got = eng.gather_params(0)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(eng.cohort_fill(), ref.cohort_fill())


# --- the engine (the JAX package's test_population.py) -----------------------------------


def test_engine_cohort_fill_and_snapshot():
    with PopulationEngine(16, cohort_fraction=0.25, seed=2, device="cpu", **SMALL) as eng:
        res = eng.run(4)
        fill = eng.cohort_fill()
        assert np.isclose(fill.mean() * 16, eng.cohort_k)
        assert fill.sum() * 4 == np.asarray(res.committees).size
        snap = eng.snapshot(res, top_n=4)
        assert len(snap["peers"]) == 4 + 1  # top_n virtual rows + the observer's own row
        assert all(p["cohort_fill"] is not None for name, p in snap["peers"].items() if name != "population-engine")


def test_engine_checkpoint_resume_replays_cohort_accounting(tmp_path):
    kw = dict(cohort_fraction=0.5, seed=4, device="cpu", **SMALL)
    with PopulationEngine(8, **kw) as ref:
        ref.run(3)
        ref_fill = ref.cohort_fill()
        ref_hash = canonical_params_hash(ref.gather_params(0))
    ckpt = FLCheckpointer(str(tmp_path))
    with PopulationEngine(8, **kw) as victim:
        victim.run(2)
        assert victim.save_to(ckpt)
    with PopulationEngine(8, **kw) as healed:
        assert healed.load_from(ckpt) == 2
        assert healed.completed_rounds == 2
        healed.run(1)
        assert canonical_params_hash(healed.gather_params(0)) == ref_hash
        np.testing.assert_allclose(healed.cohort_fill(), ref_fill)


def test_padded_population_matches_unpadded():
    """A mesh whose "nodes" axis is 4 pads 6 virtual nodes with 2
    zero-weight fillers: the same committees and node-0 trajectory, bit for
    bit."""
    kw = dict(cohort_fraction=0.5, seed=1, device="cpu", **SMALL)
    with PopulationEngine(6, **kw) as a, PopulationEngine(6, mesh=make_mesh((4, 1), devices=["cpu"]), **kw) as b:
        assert b.sim.num_nodes == 8 and b.sim.logical_num_nodes == 6 and a.sim.num_nodes == 6
        ra, rb = a.run(2), b.run(2)
        np.testing.assert_array_equal(ra.committees, rb.committees)
        for k, v in a.gather_params(0).items():
            np.testing.assert_array_equal(v, b.gather_params(0)[k])


# --- sharding rules ----------------------------------------------------------------------


def _models():
    from p2pfl_tpu.models import mlp_model as jax_mlp, transformer_lm_model as jax_lm
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model

    return {
        "mlp": (jax_mlp(seed=0, input_shape=(6,), hidden_sizes=(4,), out_channels=3),
                mlp_model(seed=0, input_shape=(6,), hidden_sizes=(4,), out_channels=3, device="cpu")),
        "lm": (jax_lm(seed=0, seq_len=8, vocab_size=16, num_layers=2, num_heads=2, embed_dim=8),
               transformer_lm_model(seed=0, seq_len=8, vocab_size=16, num_layers=2, num_heads=2, embed_dim=8,
                                    device="cpu")),
    }


def _stacked(jm, pm, n=2):
    jt = jax.tree.map(lambda a: np.stack([np.asarray(a)] * n), jm.params)
    pt = {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in pm.params.items()}
    return jt, pt


def _flat(tree):
    return dict(zip(jax.tree.leaves(jax_tree_path_names(tree)), jax.tree.leaves(tree)))


@pytest.mark.parametrize("which", ["mlp", "lm"])
def test_tree_path_names_are_the_jax_package_paths(which):
    jm, pm = _models()[which]
    names = tree_path_names(pm.params)
    assert sorted(names.values()) == sorted(jax.tree.leaves(jax_tree_path_names(jm.params)))
    assert tree_path_names({"opt": [pm.params]})["opt"][0] == {k: "opt/0/" + v for k, v in names.items()}


@pytest.mark.parametrize("model_parallel", [False, True])
@pytest.mark.parametrize("which", ["mlp", "lm"])
def test_partition_rules_select_the_jax_package_leaves(which, model_parallel):
    """Each port leaf gets the spec of the JAX package's leaf at the same
    path, its axes moved to the port's layout (a stacked Dense kernel
    ``[N, in, out]`` there is ``[N, out, in]`` here)."""
    jm, pm = _models()[which]
    jt, pt = _stacked(jm, pm)
    want = dict(zip(jax.tree.leaves(jax_tree_path_names(jt)),
                    jax.tree.leaves(jax_match_partition_rules(jax_population_partition_rules(model_parallel), jt),
                                    is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    got = match_partition_rules(population_partition_rules(model_parallel), pt)
    names = tree_path_names(pt)
    split = 0
    for k, spec in got.items():
        assert isinstance(spec, PartitionSpec)
        ref = tuple(want[names[k]]) + (None,) * (pt[k].dim() - len(want[names[k]]))
        kind = flax_path(k)[1]
        perm = (0, 2, 1) if kind == "dense" else tuple(range(pt[k].dim()))  # port axis -> JAX axis
        mine = tuple(spec) + (None,) * (pt[k].dim() - len(spec))
        assert mine == tuple(ref[perm[i]] for i in range(pt[k].dim())), (k, spec, want[names[k]])
        split += "model" in spec
    assert (split > 0) == model_parallel


def test_strict_rules_raise_for_an_unmatched_leaf():
    jm, pm = _models()["mlp"]
    rules = [(r"kernel$", PartitionSpec("nodes"))]
    with pytest.raises(ValueError, match="bias"):
        match_partition_rules(rules, pm.params)
    with pytest.raises(ValueError, match="bias"):
        jax_match_partition_rules([(r"kernel$", jax.sharding.PartitionSpec("nodes"))], jm.params)
    loose = match_partition_rules(rules, pm.params, strict=False)
    assert loose["Dense_0.bias"] == PartitionSpec() and loose["Dense_0.weight"] == PartitionSpec("nodes")
    assert match_partition_rules(rules, {"x.scale": torch.zeros(1)}) == {"x.scale": PartitionSpec()}


def test_shard_and_gather_fns():
    mesh = make_mesh(devices=["cpu"])
    specs = {"a.weight": PartitionSpec("nodes"), "b.weight": PartitionSpec()}
    shard, gather = make_shard_and_gather_fns(specs, mesh)
    placed = shard["a.weight"](np.arange(4, dtype=np.float32))
    assert isinstance(placed, torch.Tensor) and placed.device == mesh.device
    back = gather["b.weight"](torch.tensor([1.5, -2.0]).bfloat16())
    assert isinstance(back, np.ndarray) and back.dtype == np.float32 and back.tolist() == [1.5, -2.0]


# --- the mesh helpers ------------------------------------------------------------------


def test_make_mesh_and_shardings():
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == {"nodes": 1, "model": 1} and mesh.device == torch.device("cpu")
    assert make_mesh((4, 2), devices=["cpu"]).shape == {"nodes": 4, "model": 2}
    assert make_mesh((8,), ("stage",), devices=["cpu"]).shape == {"stage": 8}
    with pytest.raises(ValueError, match="one device"):
        make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((1, 1, 1), devices=["cpu"])
    ps = population_sharding(mesh)
    assert isinstance(ps, NamedSharding) and ps.spec == PartitionSpec("nodes") and ps.device == mesh.device
    assert replicated(mesh).spec == PartitionSpec() == ()
    with pytest.raises(ValueError, match="no axis"):
        population_sharding(mesh, "seq")


def test_initialize_multihost_is_a_noop_alone_and_joins_when_asked(monkeypatch):
    """Nothing asks to join: a no-op, as in the JAX package. Asked through
    the coordinator arguments (or the JAX package's variables), it joins a
    gloo process group on the CPU, idempotently, and ``make_mesh`` spans its
    ranks; without a coordinator to reach it raises."""
    import socket

    import torch.distributed as dist

    from p2pfl_tpu_torch.parallel import mesh as mesh_mod

    for k in ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID",
              "MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is None and not dist.is_initialized()
    with pytest.raises(ValueError, match="no coordinator"):
        initialize_multihost(num_processes=1, process_id=0, device="cpu")
    for how in ("arguments", "environment"):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{sock.getsockname()[1]}"
        if how == "environment":
            monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", addr)
            monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
            monkeypatch.setenv("JAX_PROCESS_ID", "0")
            args = ()
        else:
            args = (addr, 1, 0)
        try:
            joined = initialize_multihost(*args, device="cpu")
            assert joined == {"device": torch.device("cpu"), "backend": "gloo", "rank": 0, "world": 1}
            assert dist.is_initialized() and dist.get_backend() == "gloo"
            assert initialize_multihost(*args, device="cpu") is joined  # idempotent
            mesh = make_mesh(devices=["cpu"])
            assert mesh.ranked and (mesh.rank, mesh.world) == (0, 1) and mesh.shape == {"nodes": 1, "model": 1}
            assert (mesh.process_index(), mesh.process_count(), mesh.slab(6)) == (0, 1, (0, 6))
        finally:
            mesh_mod.shutdown_multihost()
        assert not dist.is_initialized() and mesh_mod.JOINED is None