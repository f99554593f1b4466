"""The port's node learner and node-mode aggregators against the JAX
package's: ``TorchLearner`` against ``JaxLearner``, each aggregator against
its reference class on the same handles, and the async buffer's staleness
math and window semantics (as tests/test_async.py checks the JAX ones).

Tolerances: 1e-5 on parameters and metrics, the MLP round's bar in
tests/test_torch_classification.py (f32 compute on both sides; they differ
only in the order of their f32 sums). The batch is all of a node's samples
and the seed is pinned, so both learners shuffle alike (the port's
``export_batches`` draws the JAX package's permutation anyway). Krum's
selection is compared exactly on tie-free inputs.
"""

import threading
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.learning import aggregators as jax_aggs
from p2pfl_tpu.learning.learner import JaxLearner
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning import aggregators as aggs
from p2pfl_tpu_torch.learning.aggregators.async_buffer import AsyncBufferedAggregator
from p2pfl_tpu_torch.learning.learner import LearnerFactory, TorchLearner
from p2pfl_tpu_torch.optim import sgd
from test_torch_classification import SAMPLES, mlp_handles, mnist_partitions

ATOL = 1e-5


def _close_leaves(port_leaves, jax_leaves, atol=ATOL):
    assert len(port_leaves) == len(jax_leaves)
    for a, b in zip(port_leaves, jax_leaves):
        np.testing.assert_allclose(np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a),
                                   np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(fedprox_mu=0.1), dict(dp_clip_norm=1.0, dp_noise_multiplier=0.0), dict(callbacks=["scaffold"])],
    ids=["adam", "fedprox", "dp-clip-only", "scaffold"],
)
def test_torch_learner_matches_jax_learner(kwargs):
    jh, ph = mlp_handles(1)
    jparts, pparts = mnist_partitions()
    common = dict(batch_size=SAMPLES, seed=5, **kwargs)
    if "callbacks" in kwargs:  # SCAFFOLD's option II holds for SGD at lr
        jl = JaxLearner(jh, jparts[0], "n0", lr=0.05, **common)
        import optax

        jl.optimizer = optax.sgd(0.05)
        pl = TorchLearner(ph, pparts[0], "n0", optimizer=sgd(0.05), lr=0.05, device="cpu", **common)
    else:
        jl = JaxLearner(jh, jparts[0], "n0", lr=1e-2, **common)
        pl = TorchLearner(ph, pparts[0], "n0", lr=1e-2, device="cpu", **common)
    for fit in range(2):
        if fit and "callbacks" in kwargs:  # the server's control variate reaches both learners
            rng = np.random.default_rng(9)
            global_c = [rng.normal(scale=0.01, size=np.shape(a)).astype(np.float32) for a in jh.get_parameters()]
            jh.add_info("scaffold_server", {"global_c": global_c})
            ph.add_info("scaffold_server", {"global_c": [torch.from_numpy(a.copy()) for a in global_c]})
        jm, pm = jl.fit(), pl.fit()
        _close_leaves(pm.get_parameters(), jm.get_parameters())
        assert pm.contributors == jm.contributors == ["n0"] and pm.num_samples == jm.num_samples
    je, pe = jl.evaluate(), pl.evaluate()
    assert set(pe) == set(je) == {"test_loss", "test_acc"}
    for k in je:
        assert abs(pe[k] - je[k]) <= ATOL, (k, pe[k], je[k])
    if "callbacks" in kwargs:
        for key in ("delta_y_i", "delta_c_i"):
            _close_leaves(pm.get_info("scaffold")[key], jm.get_info("scaffold")[key])
    assert pl.privacy_spent() == jl.privacy_spent()
    assert LearnerFactory.create_learner(pm) is TorchLearner and pm.get_framework() == "torch"


def test_torch_learner_interrupt_dp_guard_and_lm_task():
    jparts, pparts = mnist_partitions()
    _, ph = mlp_handles(2)
    with pytest.raises(ValueError, match="dp_clip_norm"):
        TorchLearner(ph, pparts[0], dp_noise_multiplier=1.0, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        TorchLearner(ph, pparts[0], seed=0, device="cpu").cost_analysis()
    learner = TorchLearner(ph, pparts[0], batch_size=4, seed=0, interrupt_every=2, device="cpu")
    learner.set_epochs(3)
    learner.interrupt_fit()  # cleared at fit start: a stale request does not skip the fit
    start = {k: v.clone() for k, v in ph.params.items()}
    learner.fit()
    assert any(not torch.equal(ph.params[k], start[k]) for k in start)
    # A causal LM on a flash transformer: the loss falls over a few fits.
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model

    rng = np.random.default_rng(0)
    tok = lambda n: ((rng.integers(0, 32, size=(n, 1)) + np.arange(16)) % 32).astype(np.int32)  # noqa: E731
    data = FederatedDataset.from_arrays(tok(16), np.zeros(16, np.int32), tok(8), np.zeros(8, np.int32))
    lm = transformer_lm_model(seed=0, seq_len=16, vocab_size=32, num_layers=1, num_heads=2, embed_dim=32,
                              attention_kind="flash", device="cpu")
    lm_learner = TorchLearner(lm, data, lr=1e-2, batch_size=4, seed=1, task="lm", device="cpu")
    before = lm_learner.evaluate()["test_loss"]
    for _ in range(3):
        lm_learner.fit()
    after = lm_learner.evaluate()
    assert np.isfinite(after["test_loss"]) and after["test_loss"] < before and 0.0 <= after["test_acc"] <= 1.0


def _handle_pairs(n=4, seed=0, samples=(10, 20, 30, 40)):
    """``n`` JAX / port MLP handle pairs with equal, tie-free random weights."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        jh, ph = mlp_handles(0)
        leaves = [np.asarray(a) + rng.normal(scale=0.1 * (i + 1), size=np.shape(a)).astype(np.float32)
                  for a in jh.get_parameters()]
        jh.set_parameters(leaves)
        ph.set_parameters([torch.from_numpy(np.array(a)) for a in leaves])
        for h in (jh, ph):
            h.set_contribution([f"n{i}"], samples[i])
        out.append((jh, ph))
    return out


@pytest.mark.parametrize(
    "name,make",
    [
        ("fedavg", lambda m: m.FedAvg()),
        ("canonical_fedavg", lambda m: m.CanonicalFedAvg()),
        ("fedmedian", lambda m: m.FedMedian()),
        ("trimmed_mean", lambda m: m.TrimmedMean(0.25)),
        ("geometric_median", lambda m: m.GeometricMedian(iters=8)),
        ("krum", lambda m: m.Krum(num_byzantine=1)),
        ("multikrum", lambda m: m.MultiKrum(num_byzantine=1)),
    ],
)
def test_node_aggregators_match_jax(name, make):
    pairs = _handle_pairs()
    if name == "canonical_fedavg":
        pairs = pairs[::-1]  # arrival order must not matter
    ref = make(jax_aggs).aggregate([j for j, _ in pairs])
    got = make(aggs).aggregate([p for _, p in pairs])
    _close_leaves(got.get_parameters(), ref.get_parameters())
    assert got.contributors == ref.contributors  # Krum's selection, exactly
    assert got.get_num_samples() == ref.get_num_samples()


def test_scaffold_aggregator_matches_jax_over_rounds():
    rng = np.random.default_rng(3)
    jagg, pagg = jax_aggs.Scaffold(global_lr=0.5, total_population=8), aggs.Scaffold(global_lr=0.5, total_population=8)
    for _ in range(2):
        pairs = _handle_pairs(3, seed=int(rng.integers(1 << 30)))
        for j, p in pairs:
            info = {key: [rng.normal(scale=0.01, size=np.shape(a)).astype(np.float32) for a in j.get_parameters()]
                    for key in ("delta_y_i", "delta_c_i")}
            j.add_info("scaffold", info)
            p.add_info("scaffold", {k: [torch.from_numpy(a.copy()) for a in v] for k, v in info.items()})
        ref = jagg.aggregate([j for j, _ in pairs])
        got = pagg.aggregate([p for _, p in pairs])
        _close_leaves(got.get_parameters(), ref.get_parameters())
        _close_leaves(got.get_info("scaffold_server")["global_c"], ref.get_info("scaffold_server")["global_c"])
        assert "scaffold" not in got.additional_info
    assert pagg.get_required_callbacks() == ["scaffold"]


def test_aggregator_round_lifecycle_matches_jax():
    """The same scripted round on both bases: round gating, subset dedup,
    partial models, death shrink, retirement and the finish condition."""
    results = []
    for mod, pick in ((jax_aggs, 0), (aggs, 1)):
        pairs = _handle_pairs()
        h = [pair[pick] for pair in pairs]
        agg = mod.FedAvg()
        agg.set_addr("n0")
        trace = [agg.add_model(h[0], round=0)]  # not open yet
        agg.set_nodes_to_aggregate(["n0", "n1", "n2", "n3"], round=3)
        trace.append(agg.add_model(h[0], round=2))  # another round
        trace.append(agg.add_model(h[0], round=3))
        trace.append(agg.add_model(h[0], round=3))  # duplicate
        trace.append(agg.add_model(h[1]))
        partial = agg.get_partial_model(["n0"])
        trace.append(sorted(partial.contributors))
        trace.append(agg.get_missing_models())
        trace.append(agg.remove_node("n3"))
        trace.append(agg.remove_node("n1"))  # already contributed: kept
        trace.append(agg.serves_round(3))
        trace.append(agg.add_model(h[2], round=3))
        out = agg.wait_and_get_aggregation(timeout=5.0)
        trace.append((sorted(out.contributors), out.get_num_samples()))
        agg.retire_round()
        trace.append((agg.serves_round(3), agg.serves_round(4)))
        trace.append(sorted(agg.get_partial_model_for_round(3, ["n0"]).contributors))
        results.append((trace, [np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
                                for a in out.get_parameters()]))
    assert results[0][0] == results[1][0]
    _close_leaves(results[1][1], results[0][1])


def test_aggregator_stall_patience_and_timeout_aggregate_what_arrived():
    pairs = _handle_pairs(2)
    with Settings.overridden(AGGREGATION_STALL_PATIENCE=0.3):
        agg = aggs.FedAvg()
        agg.set_nodes_to_aggregate(["n0", "n1", "dead"])
        agg.add_model(pairs[0][1])
        stalled = []
        agg.on_stall = stalled.append
        t0 = time.monotonic()
        out = agg.wait_and_get_aggregation(timeout=30.0)
        assert time.monotonic() - t0 < 5.0 and stalled == [["dead", "n1"]]
        assert out.contributors == ["n0"]
    agg = aggs.Krum()
    agg.set_nodes_to_aggregate(["n0"])
    with pytest.raises(RuntimeError, match="no models"):
        agg.wait_and_get_aggregation(timeout=0.3)


# --- async buffer (as tests/test_async.py holds the JAX one) --------------------


def test_staleness_weight_identity_monotonicity_and_jax_values():
    from p2pfl_tpu.learning.aggregators import staleness_discount as jax_discount
    from p2pfl_tpu.learning.aggregators import staleness_weight as jax_weight

    for alpha in (0.0, 0.25, 0.5, 1.0, 4.0):
        assert aggs.staleness_weight(0, alpha) == 1.0
    for alpha in (0.25, 0.5, 1.0):
        ws = [aggs.staleness_weight(lag, alpha) for lag in range(8)]
        assert all(a > b for a, b in zip(ws, ws[1:]))
        np.testing.assert_allclose(ws, [jax_weight(lag, alpha) for lag in range(8)], rtol=1e-6)
    assert [aggs.staleness_weight(lag, 0.0) for lag in range(5)] == [1.0] * 5
    assert aggs.staleness_weight(-3, 1.0) == 1.0
    lags = np.arange(-2, 6)
    np.testing.assert_allclose(aggs.staleness_discount(lags, 0.5).numpy(), np.asarray(jax_discount(lags, 0.5)),
                               rtol=1e-6)
    with Settings.overridden(ASYNC_STALENESS_ALPHA=1.0), JaxSettings.overridden(ASYNC_STALENESS_ALPHA=1.0):
        assert aggs.staleness_weight(1) == jax_weight(1) == 0.5


def test_zero_staleness_window_is_bit_exact_fedavg_and_matches_jax():
    pairs = _handle_pairs(3)
    models = [p for _, p in pairs]
    ref = aggs.FedAvg().aggregate(list(models))
    out = AsyncBufferedAggregator.aggregate_weighted(list(models), [0, 0, 0])
    for a, b in zip(out.get_parameters(), ref.get_parameters()):
        assert torch.equal(a, b)
    assert out.contributors == ref.contributors and out.get_num_samples() == ref.get_num_samples()
    jax_out = jax_aggs.AsyncBufferedAggregator.aggregate_weighted([j for j, _ in pairs], [0, 3, 1], alpha=0.5)
    got = AsyncBufferedAggregator.aggregate_weighted(list(models), [0, 3, 1], alpha=0.5)
    _close_leaves(got.get_parameters(), jax_out.get_parameters())


def test_async_window_semantics():
    pairs = _handle_pairs(3)
    # completes on the own contribution when everyone else is dead
    agg = AsyncBufferedAggregator("me")
    agg.open_window(0)
    agg.fold(pairs[0][1], 0, "me")
    t0 = time.monotonic()
    out = agg.wait_window(lambda: 1, timeout=30.0)
    assert time.monotonic() - t0 < 1.0 and out.get_num_samples() == 10 and agg.last_close_reason == "fill"
    # the target shrinks live through notify()
    agg = AsyncBufferedAggregator("me")
    agg.open_window(0)
    agg.fold(pairs[0][1], 0, "me")
    target, done, result = {"n": 2}, threading.Event(), {}

    def waiter():
        result["model"] = agg.wait_window(lambda: target["n"], timeout=20.0)
        done.set()

    threading.Thread(target=waiter, daemon=True).start()
    time.sleep(0.6)
    assert not done.is_set()
    target["n"] = 1
    agg.notify()
    assert done.wait(timeout=2.0) and result["model"] is not None and agg.last_close_reason == "shrink"
    # contributions past ASYNC_MAX_STALENESS are dropped; lag is clamped at 0
    with Settings.overridden(ASYNC_MAX_STALENESS=2):
        agg = AsyncBufferedAggregator("me")
        agg.open_window(10)
        assert not agg.fold(pairs[1][1], 7, "laggard") and agg.fill() == 0
        assert agg.fold(pairs[1][1], 8, "laggard")
        assert agg.fold(pairs[2][1], 12, "fast")
        out = agg.wait_window(lambda: 2, timeout=5.0)
        assert list(agg.lag_log) == [2, 0] and agg.last_mean_lag == 1.0
    # early stop returns None
    agg = AsyncBufferedAggregator("me")
    agg.open_window(0)
    assert agg.wait_window(lambda: 5, timeout=10.0, early_stop_fn=lambda: True) is None
    # a robust rule takes the buffered individuals
    agg = AsyncBufferedAggregator("me", rule=aggs.FedMedian().aggregate)
    for i, (_, p) in enumerate(pairs):
        agg.fold(p, 0, f"n{i}")
    out = agg.wait_window(lambda: 3, timeout=5.0)
    assert out.contributors == ["n0", "n1", "n2"]
