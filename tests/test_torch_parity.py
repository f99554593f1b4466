"""The port's parity harness: the wire's model plane (``run_frames``:
``ParityLearner`` fits, dense PFLT frames, ``CanonicalFedAvg``) against the
port's fused round (``run_fused``) — bit-equal ``canonical_params_hash`` every
round, as the ROADMAP's hash-parity contract inside the port asks — then
the port's ``run_fused`` against the JAX package's on weights converted from
JAX (params and losses within 1e-5, f32 compute, one batch per node so the
two frameworks' shuffles only reorder one batch), and ``attach_ledger``
events against the JAX simulation's, field for field but the hashes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.learning.learner import softmax_cross_entropy as jax_ce
from p2pfl_tpu.models.mlp import mlp_model as jax_mlp_model
from p2pfl_tpu.parallel import simulation as jax_simulation
from p2pfl_tpu.parallel.mesh import make_mesh
from p2pfl_tpu.parity import ParityScenario as JaxScenario
from p2pfl_tpu.parity import run_fused as jax_run_fused
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.models.mlp import MLP
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
from p2pfl_tpu_torch.parity import ParityScenario, round_member_keys, run_frames, run_fused
from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, TRAJECTORY_KINDS

SCENARIO = dict(seed=7, n_nodes=4, rounds=3, samples_per_node=32, byzantine={1: "signflip"})


def _trajectory(events, drop=("seq",)):
    return [{k: v for k, v in ev.items() if k not in drop} for ev in events if ev["kind"] in TRAJECTORY_KINDS]


def test_wire_model_plane_and_fused_round_hash_bit_equal_every_round():
    scn = ParityScenario(batch_size=16, **SCENARIO)
    LEDGERS.reset()
    wire, fused = run_frames(scn, device="cpu"), run_fused(scn, device="cpu")
    assert sorted(wire["hashes"]) == sorted(fused["hashes"]) == [0, 1, 2]
    assert wire["hashes"] == fused["hashes"]
    assert _trajectory(wire["events"]) == _trajectory(fused["events"])
    for a, b in zip(wire["params"], fused["params"]):
        np.testing.assert_array_equal(a, b)
    # The Byzantine node's poisoning shows: without it the hashes differ.
    honest = run_fused(ParityScenario(batch_size=16, **{**SCENARIO, "byzantine": {}}), device="cpu")
    assert honest["hashes"][0] != fused["hashes"][0]
    gens = round_member_keys(7, 2, 4)
    assert len(gens) == 4 and torch.equal(torch.rand(3, generator=gens[1]), torch.rand(3, generator=round_member_keys(7, 2, 4)[1]))


class _F32Scenario(ParityScenario):
    """The scenario with an f32 MLP carrying the JAX package's initial weights."""

    def template_model(self, device="cuda"):
        with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
            params = jax_mlp_model(seed=self.seed, hidden_sizes=self.hidden).params
        with torch.device("meta"):
            module = MLP(784, self.hidden, 10, torch.float32)
        return ModelHandle(flax_to_torch(params, device=device), module)


def test_port_run_fused_matches_jax_run_fused(monkeypatch):
    kw = dict(batch_size=SCENARIO["samples_per_node"], **SCENARIO)
    final = {}
    close = jax_simulation.MeshSimulation.close

    def keep_final_model(sim):
        final["params"] = sim.final_model().get_parameters()
        close(sim)

    monkeypatch.setattr(jax_simulation.MeshSimulation, "close", keep_final_model)
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        ref = jax_run_fused(JaxScenario(**kw), mesh=make_mesh(devices=jax.devices()[:1]))
    LEDGERS.reset()  # the hub is process-wide: drop the earlier runs' "mesh-sim" events
    got = run_fused(_F32Scenario(**kw), device="cpu")
    assert len(got["params"]) == len(final["params"])
    for a, b in zip(got["params"], final["params"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    # The final models' losses on the scenario's data.
    x, y, _ = ParityScenario(**kw).data()
    xs, ys = x.reshape(-1, 28, 28), y.reshape(-1)
    model = _F32Scenario(**kw).template_model("cpu")
    model.set_parameters([torch.from_numpy(np.array(a)) for a in got["params"]])
    loss = float(softmax_cross_entropy(model.apply(model.params, torch.from_numpy(xs)), torch.from_numpy(ys).long(),
                                       torch.ones(len(ys))))
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        jm = jax_mlp_model(seed=kw["seed"], hidden_sizes=(32,))
    jm.set_parameters([np.asarray(a) for a in final["params"]])
    ref_loss = float(jax_ce(jm.apply_fn(jm.params, jnp.asarray(xs)), jnp.asarray(ys), jnp.ones(len(ys))))
    assert abs(loss - ref_loss) <= 1e-5
    # Same trajectory, field for field but the hashes (f32 sums in another order).
    assert _trajectory(got["events"], ("seq", "hash")) == _trajectory(ref["events"], ("seq", "hash"))


def test_attach_ledger_events_match_jax_field_for_field():
    """A scheduled run with a fold schedule and chunks of 2 rounds: the
    committee, the folded contributions, the commits (hashes present on
    the same rounds) and the Byzantine facts, as the JAX simulation emits
    them."""
    from p2pfl_tpu.telemetry.ledger import LEDGERS as JAX_LEDGERS
    from test_torch_classification import mlp_handles, mnist_partitions

    sched = np.array([[0, 2, 3], [1, 2, 3], [3, 0, 1]], np.int32)
    fold = np.array([[0, 2], [1, 2], [2, 0]], np.int32)
    byz = np.array([0, 0, 1, 0], np.float32)
    jh, ph = mlp_handles()
    jp, pp = mnist_partitions()
    names = [f"node-{i}" for i in range(4)]
    kw = dict(train_set_size=3, batch_size=32, lr=1e-3, seed=0, byzantine_mask=byz)
    run_kw = dict(rounds=3, warmup=False, committee_schedule=sched, fold_schedule=fold, rounds_per_call=2)
    events = []
    for ledgers, settings, make in (
        (JAX_LEDGERS, JaxSettings, lambda: jax_simulation.MeshSimulation(
            jh, jp, mesh=make_mesh(devices=jax.devices()[:1]), **kw)),
        (LEDGERS, Settings, lambda: MeshSimulation(ph, pp, device="cpu", **kw)),
    ):
        ledgers.reset()
        with settings.overridden(LEDGER_ENABLED=True):
            sim = make()
            led = sim.attach_ledger(node="sim", node_names=names, run_id="r1")
            sim.run(**run_kw)
            events.append(led.canonical_events())
            sim.close()
    ref, got = events
    assert [("hash" in e) for e in got] == [("hash" in e) for e in ref]
    assert sum("hash" in e for e in got) == 2  # rounds 1 (end of the first chunk) and 2 (the last)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "hash"} for e in evs]  # noqa: E731
    assert strip(got) == strip(ref)
    assert any(e["kind"] == "chaos_fault" and e["peer"] == "node-2" for e in got)
