"""The ``expert`` and ``model`` mesh axes over ranks, on the CPU with gloo.

Two worlds of ``tests/torch_expert_model_worker.py`` run side by side, W = 2
and W = 4, each rank a process started by the port's ``launch`` on one CPU
thread. Every rank's outputs are held:

* against the JAX package on W devices of the virtual CPU mesh, run as its
  own tests run it, in a process of its own
  (``tests/torch_expert_model_refs.py``): ``shard_moe_params`` with the
  jitted apply and ``jax.grad``
  (``tests/test_moe.py::test_expert_parallel_matches_unsharded`` at f32,
  plus two Adam steps), the ring MoE LM under ``shard_map`` with
  ``make_sequence_parallel_train_step``, and ``MeshSimulation`` on
  ``make_mesh((1, W), ("nodes", "model"))``: the MLP round with FedAdam (the
  dryrun core phase's), with the update-norm clip and with Krum, and the
  flash LM round. Bars: f32 forwards 1e-5, gradients and parameters 1e-4;
* against the one-process port, run by the same rank on the same thread
  count: 1e-5, since the sums over ranks run in another order (the MoE's
  add exact zeros and come out equal);
* against each other: the replicated leaves, and every gathered model,
  bit-equal on every rank.

The small configuration: the MoE LM with 2 layers, width 32, 2 heads, vocab
32, 4 experts; an MLP 784-16-8-10 over 4 nodes of 32 samples; the LM with 2
layers, width 64, 4 heads, sequence 64, vocab 64; f32 throughout. The JAX
package's initial weights are drawn here; its references are computed by
their own process while the worlds run.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_expert_model_refs as refs_mod
import torch_expert_model_worker as worker
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.parallel.launch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = refs_mod.WORLDS
DEADLINE_S = 300.0
FWD, GRAD, ONE = 1e-5, 1e-4, 1e-5
JAX_ARMS = refs_mod.JAX_ARMS


def _torch(tree):
    return flax_to_torch(tree, device="cpu")


def _jax_init():
    """The JAX package's initial weights, as the port's leaves."""
    return {
        # Without the "losses" its init sowed: the apply would add that aux to its own.
        "moe": refs_mod._jax_moe_module().init(jax.random.key(0), jnp.zeros((1, worker.MOE_SEQ), jnp.int32))[
            "params"],
        "mlp": refs_mod._jax_mlp()[1]["params"],
        "lm": refs_mod._jax_lm().init(jax.random.key(1), jnp.zeros((1, worker.LM_SEQ), jnp.int32))["params"],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(worlds, refs)``: both worlds' saved results, ``{W: [rank 0's,
    ...]}``, after each rank exited 0 (its output is in the assertion
    otherwise), and the JAX references, computed while the worlds ran."""
    init = _jax_init()
    out_dir = tmp_path_factory.mktemp("expert_model")
    torch.save({k: _torch(v) for k, v in init.items()}, out_dir / "init.pt")
    env = {**os.environ, "PYTHONPATH": ROOT}
    got = {}

    def start(world):
        got[world] = launch([sys.executable, os.path.join(ROOT, "tests", "torch_expert_model_worker.py"),
                             str(out_dir)], world, timeout_s=DEADLINE_S, env={**env, "OMP_NUM_THREADS": "1"},
                            cwd=ROOT)

    with open(out_dir / "refs.log", "w+") as log:
        refs_proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_expert_model_refs.py"),
                                      str(out_dir)], env={**env, "JAX_PLATFORMS": "cpu"}, cwd=ROOT, stdout=log,
                                     stderr=subprocess.STDOUT)
        threads = [threading.Thread(target=start, args=(w,)) for w in WORLDS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        try:
            refs_proc.wait(timeout=DEADLINE_S)
        finally:
            if refs_proc.poll() is None:
                refs_proc.kill()
                refs_proc.wait()
        log.seek(0)
        assert refs_proc.returncode == 0, f"the JAX references exited {refs_proc.returncode}:\n{log.read()[-4000:]}"
    refs = torch.load(out_dir / "refs.pt", weights_only=False)
    for world in WORLDS:
        for rank, (rc, out) in enumerate(got[world]):
            assert rc == 0, f"world {world} rank {rank} exited {rc}:\n{out[-4000:]}"
            assert f"WORKER_DONE rank={rank} world={world}" in out, out[-2000:]
    worlds = {w: [torch.load(out_dir / f"w{w}_r{r}.pt", weights_only=False) for r in range(w)] for w in WORLDS}
    return worlds, refs


def _close(got, want, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def _experts(name, t, world, rank):
    """Rank ``rank``'s experts of a whole MoE leaf (the leaf itself unless it
    is a stacked ``wi`` / ``wo`` that splits over W)."""
    if ".moe.w" in name and t.shape[0] % world == 0:
        per = t.shape[0] // world
        return t[rank * per:(rank + 1) * per]
    return t


def _equal_on_every_rank(ranks, pick):
    first = pick(ranks[0])
    for got in ranks[1:]:
        for k, v in pick(got).items():
            assert torch.equal(v, first[k]), (got["rank"], k)


# --- collectives --------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_dim_concatenates_in_rank_order_and_its_gradient_is_the_local_slice(world, runs):
    for got in runs[0][world]:
        c, r = got["collectives"], got["rank"]
        want = torch.cat([torch.full((2, 3), float(i + 1)) for i in range(world)], dim=-1)
        assert torch.equal(c["y"], want)
        # The cotangent w's columns 3r .. 3r + 2, not a sum over the ranks.
        w = torch.arange(float(2 * 3 * world)).reshape(2, 3 * world)
        assert torch.equal(c["gx"], w[:, 3 * r:3 * r + 3])
        assert c["bf"].dtype == torch.bfloat16 and c["bf"].float().tolist() == [[i + 0.5] * 2 for i in range(world)]
        assert c["route"] == "direct"  # gloo between CPU tensors; CUDA tensors go through host memory


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_dim_and_sums_count_their_bytes(world, runs):
    for got in runs[0][world]:
        c = got["collectives"]
        assert c["gather_bytes"] == 2 * 3 * world * 4 + world * 2 * 2  # the f32 [2, 3 W] and the bf16 [W, 2]
        # sum_cotangent's backward summed a [3] f32 cotangent, psum a [4] f32.
        assert c["sum_bytes"] == 3 * 4 + 4 * 4
        assert c["gs"].tolist() == [world * (world + 1) / 2] * 3
        assert c["psum"].tolist() == [float(world)] * 4


# --- the expert axis ----------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_moe_matches_jax_and_one_process(world, runs):
    logits, aux, grads, losses, params, spec = runs[1]["moe", world]
    assert spec == "PartitionSpec('expert',)"
    ranks = runs[0][world]
    for got in ranks:
        r, mine, one = got["rank"], got["moe"]["ranks"], got["moe"]["one"]
        _close(mine["logits"], logits, FWD, f"logits rank {r}")
        _close(mine["logits"], one["logits"], ONE, "logits vs one process")
        assert abs(mine["aux"] - aux) < FWD and abs(mine["aux"] - one["aux"]) < ONE
        np.testing.assert_allclose(mine["losses"], losses, atol=FWD, rtol=0)
        assert mine["losses"][-1] < mine["losses"][0]
        per = worker.MOE_EXPERTS // world
        for name, shape in mine["shapes"].items():
            assert shape[0] == (per if ".moe.w" in name else params[name].shape[0]), (name, shape)
        for what, ref, mine_t in (("grad", grads, mine["grads"]), ("param", params, mine["params"])):
            for name, t in mine_t.items():
                _close(t, _experts(name, ref[name], world, r), GRAD, f"{what} {name} rank {r}")
                _close(t, _experts(name, one[what + "s"][name], world, r), ONE, f"{what} {name} vs one process")
    _equal_on_every_rank(ranks, lambda got: {k: v for k, v in got["moe"]["ranks"]["params"].items()
                                             if ".moe.w" not in k})


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_moe_sums_only_its_partial_combines_and_cotangents(world, runs):
    """Per routed block: the forward psum of the [T, E] partial combine, and
    in the backward the [T] gate's and the [T, E] tokens' cotangents; never
    the [T, X, C] combine's."""
    t, e = worker.MOE_BATCH * worker.MOE_SEQ, worker.MOE_EMBED
    routed = worker.MOE_LAYERS // 2
    for got in runs[0][world]:
        assert got["moe"]["ranks"]["sum_bytes"] == routed * (t * e + t + t * e) * 4
        assert got["moe"]["one"]["sum_bytes"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_moe_lm_over_a_ranked_seq_axis_routes_each_shard_as_jax_does(world, runs):
    logits, losses, params = runs[1]["moe_seq", world]
    ranks = runs[0][world]
    for got in ranks:
        r, mine = got["rank"], got["moe_seq"]
        _close(mine["logits"], np.array_split(logits, world, axis=1)[r], FWD, f"logits rank {r}")
        np.testing.assert_allclose(mine["losses"], losses, atol=FWD, rtol=0)
        for name, p in mine["params"].items():
            _close(p, params[name], GRAD, f"{name} rank {r}")
    _equal_on_every_rank(ranks, lambda got: got["moe_seq"]["params"])


# --- the model axis -----------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_split_rule_follows_stacked_spec_leaf_by_leaf(world, runs):
    """The MLP (whose 10-class head does not divide at W 4), the LM (the
    embedding on its feature dimension) and the CNN."""
    for model in ("fedadam", "lm"):
        jax_split = runs[1]["sims", world][model][3]
        for got in runs[0][world]:
            dims = got["sims"][model]["ranks"]["dims"]
            assert set(dims) == jax_split, (model, sorted(dims), sorted(jax_split))
            whole = got["sims"][model]["ranks"]["whole"]
            local = got["sims"][model]["ranks"]["local0"]
            for name, t in whole.items():
                if name in dims:
                    assert local[name].shape[dims[name]] * world == t.shape[dims[name]], name
                else:
                    assert local[name].shape == t.shape, name
    # 10 classes split over 2, not over 4.
    assert ("Dense_2.weight" in runs[1]["sims", world]["fedadam"][3]) == (world == 2)
    assert runs[0][world][0]["sims"]["lm"]["ranks"]["dims"]["embed.weight"] == 1
    jax_cnn, port_cnn = runs[1]["cnn_split", world]
    assert set(port_cnn) == jax_cnn and port_cnn["Conv_0.weight"] == 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arm", JAX_ARMS + ("lm",))
def test_model_parallel_round_matches_jax_and_one_process(world, arm, runs):
    loss, acc, node0, _ = runs[1]["sims", world][arm]
    ranks = runs[0][world]
    for got in ranks:
        r, mine, one = got["rank"], got["sims"][arm]["ranks"], got["sims"][arm]["one"]
        np.testing.assert_allclose(mine["test_loss"], loss, atol=FWD, rtol=0, err_msg=f"rank {r}")
        np.testing.assert_allclose(mine["test_acc"], acc, atol=FWD, rtol=0)
        np.testing.assert_allclose(mine["test_loss"], one["test_loss"], atol=ONE, rtol=0)
        for name, t in mine["whole"].items():
            _close(t, node0[name], GRAD, f"{arm} {name} rank {r}")
            _close(t, one["whole"][name], ONE, f"{arm} {name} vs one process")
    _equal_on_every_rank(ranks, lambda got: got["sims"][arm]["ranks"]["whole"])
    _equal_on_every_rank(ranks, lambda got: {k: v for k, v in got["sims"][arm]["ranks"]["local0"].items()
                                             if k not in got["sims"][arm]["ranks"]["dims"]})


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arm", ["geomed", "fedprox", "dp", "scaffold", "per_node_init", "devobs"])
def test_model_parallel_round_options_match_one_process(world, arm, runs):
    """Each option whose arithmetic reduces over a whole model (the geometric
    median's norms, FedProx's penalty, DP-SGD's per-example norms, the
    devobs update norms) or follows the split leaves (SCAFFOLD's variates,
    ``per_node_init``'s whole-leaf draws) against the one-process port."""
    ranks = runs[0][world]
    for got in ranks:
        mine, one = got["sims"][arm]["ranks"], got["sims"][arm]["one"]
        np.testing.assert_allclose(mine["test_loss"], one["test_loss"], atol=ONE, rtol=0)
        for name, t in mine["whole"].items():
            _close(t, one["whole"][name], ONE, f"{arm} {name} rank {got['rank']}")
        assert mine["hash"] == ranks[0]["sims"][arm]["ranks"]["hash"]
    _equal_on_every_rank(ranks, lambda got: got["sims"][arm]["ranks"]["whole"])


@pytest.mark.parametrize("world", WORLDS)
def test_model_parallel_state_dict_gathers_the_split_optimizer_state(world, runs):
    for arm, keys in (("fedadam", ("mu", "nu")), ("scaffold", ())):
        for got in runs[0][world]:
            mine, one = got["sims"][arm]["ranks"]["state"], got["sims"][arm]["one"]["state"]
            for name, t in one["params_stack"].items():
                assert mine["params_stack"][name].shape == t.shape
                _close(mine["params_stack"][name], t, ONE, f"{arm} params_stack {name}")
            for key in keys:
                for name, t in getattr(one["opt_stack"], key).items():
                    _close(getattr(mine["opt_stack"], key)[name], t, ONE, f"{arm} {key} {name}")
            if arm == "fedadam":  # the server optimizer's moments follow the leaves too
                for name, t in one["c_global"]["server_opt"].mu.items():
                    _close(mine["c_global"]["server_opt"].mu[name], t, ONE, f"server mu {name}")
            else:
                for name, t in one["c_stack"].items():
                    _close(mine["c_stack"][name], t, ONE, f"c_stack {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_model_parallel_devobs_norms_and_ledger_hashes_are_whole_model(world, runs):
    ranks = runs[0][world]
    for got in ranks:
        mine, one = got["sims"]["devobs"]["ranks"], got["sims"]["devobs"]["one"]
        (n, total), (n_one, total_one) = mine["update_norm"], one["update_norm"]
        assert n == n_one == 4 and abs(total - total_one) < ONE
    hashes = ranks[0]["sims"]["devobs"]["ranks"]["ledger_hashes"]
    assert len(hashes) == len(worker.SCHED) and hashes[-1] == ranks[0]["sims"]["devobs"]["ranks"]["hash"]
    assert all(got["sims"]["devobs"]["ranks"]["ledger_hashes"] is None for got in ranks[1:])


@pytest.mark.parametrize("world", WORLDS)
def test_column_parallel_convolution_matches_one_process(world, runs):
    for got in runs[0][world]:
        r, mine, one = got["rank"], got["conv"]["ranks"], got["conv"]["one"]
        per = 8 // world
        _close(mine["out"], one["out"], ONE, "conv output")
        _close(mine["dx"], one["dx"], ONE, "input gradient")
        _close(mine["dw"], one["dw"][r * per:(r + 1) * per], ONE, "kernel gradient")
        _close(mine["db"], one["db"], ONE, "bias gradient (whole on every rank)")
