"""The port's profiler plane (``management/profiler.py``) and cost counts
(``ops/cost.py``) against the JAX package's contracts, on the CPU.

``profile_run`` writes a host cProfile and a ``torch.profiler`` Chrome
trace; ``device_trace_window`` is a no-op without a directory, captures
once per label and swallows profiler errors; ``perf_section`` has the
reference's shape; ``device_memory_watermark`` reads the live tensors on
the CPU. The cost analyses return the reference's keys; XLA's counts and
the port's are not compared (the port counts executed aten ops and the
flash calls' analytic work), but the flash calls' share must equal the
analytic formula, the plain versions' own products must not be counted,
and counting a round must leave the simulation's next run unchanged.
"""

import inspect
import json
import os
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu.management import profiler as ref_profiler
from p2pfl_tpu_torch.management import profiler
from p2pfl_tpu_torch.ops import cost
from p2pfl_tpu_torch.ops.attention import attention_cost, flash_attention, flash_chunk_update, init_carry
from p2pfl_tpu_torch.telemetry import REGISTRY
from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash


def test_profile_run_writes_host_profile_and_trace(tmp_path):
    with profiler.profile_run(host_dir=str(tmp_path / "host"), device_trace_dir=str(tmp_path / "dev"),
                              label="t") as info:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert set(info) == {"elapsed_s", "host_profile", "device_trace"}
    assert os.path.isfile(info["host_profile"]) and info["host_profile"].endswith(".pstat")
    assert info["device_trace"] == str(tmp_path / "dev" / "t" / profiler.TRACE_FILE)
    with open(info["device_trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with profiler.profile_run() as bare:
        pass
    assert set(bare) == {"elapsed_s"}


def test_device_trace_window_noop_capture_once_and_contained(tmp_path, caplog):
    for mod in (profiler, ref_profiler):
        with mod.device_trace_window(None) as captured:
            assert captured is None
        with mod.device_trace_window("", label="x") as captured:
            assert captured is None
    label = f"once-{time.time_ns()}"  # process-global registry: unique label
    with profiler.device_trace_window(str(tmp_path), label=label) as captured:
        assert captured == str(tmp_path / label)
        torch.ones(8) * 2
    assert os.path.isfile(os.path.join(captured, profiler.TRACE_FILE))
    assert captured in profiler.captured_device_traces()
    with profiler.device_trace_window(str(tmp_path), label=label) as again:
        assert again is None  # capture-once per label per process
    # A second profiler cannot open inside the first: the window logs and runs
    # the block anyway.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.device_trace_window(str(tmp_path), label=label + "-nested") as nested:
            ran = True
    assert ran and nested is None and "failed to start" in caplog.text


def test_perf_section_matches_jax_shape():
    sec = profiler.perf_section(REGISTRY, cost={"flops_per_epoch": 1.0}, extra={"x": 1})
    ref = ref_profiler.perf_section(cost={"flops_per_epoch": 1.0}, extra={"x": 1})
    assert sec.keys() == ref.keys() and sec["compile"].keys() == ref["compile"].keys()
    assert sec["steady_state"].keys() == ref["steady_state"].keys()
    assert sec["schema_version"] == ref["schema_version"] == profiler.PERF_SCHEMA_VERSION
    assert sec["xla_cost"] == {"flops_per_epoch": 1.0} and isinstance(sec["device_traces"], list)
    json.dumps(sec)


def test_memory_watermark_sweeps_live_tensors_on_the_cpu():
    base = profiler.live_arrays_bytes(ttl_s=0)
    keep = torch.zeros(1 << 20, dtype=torch.float32)  # 4 MiB
    view = keep[: 1 << 10]  # a view adds no storage
    grown = profiler.live_arrays_bytes(ttl_s=0)
    assert grown - base == pytest.approx(4 * (1 << 20), rel=0.05)
    assert profiler.live_arrays_bytes(ttl_s=3600) == grown  # cached within the TTL
    wm = profiler.device_memory_watermark()
    assert set(wm) == {"bytes_in_use", "peak_bytes_in_use"} and wm["bytes_in_use"] == wm["peak_bytes_in_use"] > 0
    del keep, view


# --- cost counts --------------------------------------------------------------------


def test_flash_calls_count_their_analytic_work_not_the_plain_products():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 48, 2, 16, generator=g, requires_grad=True) for _ in range(3))
    with cost.count_cost() as counter:
        flash_attention(q, k, v).sum().backward()
        carry = init_carry((2, 16, 2, 16), "cpu")
        for kv_offset in (0, 16, 32):  # diagonal, future, mixed-past
            carry = flash_chunk_update(carry, q[:, 16:32].detach(), k[:, :16].detach(), v[:, :16].detach(),
                                       16, kv_offset)
    want = {name: attention_cost(name, q, k, True)[0] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    qc, kc = q[:, 16:32], k[:, :16]
    want["flash_carry"] = sum(attention_cost("flash_carry", qc, kc, True, 16, off)[0] for off in (0, 16, 32))
    # Only the flash calls' analytic work: the plain versions' own einsums
    # (and the backward's elementwise delta) add no FLOPs.
    assert counter.flops == counter.opaque_flops == sum(want.values())
    assert counter.opaque_bytes == sum(attention_cost(n, q, k, True)[1] for n in ("flash_fwd", "flash_bwd_dq",
                                                                                  "flash_bwd_dkv")) + sum(
        attention_cost("flash_carry", qc, kc, True, 16, off)[1] for off in (0, 16, 32))
    # The causal triangle: half the pairs of a diagonal block, none of a future one.
    b, s, h, d = q.shape
    assert want["flash_fwd"] == 4 * b * h * s * s * d // 2
    assert attention_cost("flash_carry", qc, kc, True, 16, 32)[0] == 0
    assert attention_cost("flash_carry", qc, kc, True, 16, 0)[0] == 4 * b * h * 16 * 16 * d
    with pytest.raises(RuntimeError, match="already open"):
        with cost.count_cost(), cost.count_cost():
            pass
    assert cost.active() is None


def _lm_sim(**kw):
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    rng = np.random.default_rng(0)
    nodes, seqs, seq_len = 4, 4, 32
    x = ((rng.integers(0, 64, size=(nodes, seqs, 1)) + np.arange(seq_len)) % 64).astype(np.int32)
    xt = ((rng.integers(0, 64, size=(2, 1)) + np.arange(seq_len)) % 64).astype(np.int32)
    model = transformer_lm_model(seed=0, seq_len=seq_len, vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
                                 attention_kind="flash", device="cpu")
    return MeshSimulation(model, (x, np.zeros((nodes, seqs), np.int32), np.ones((nodes, seqs), np.float32)),
                          test_data=(xt, None), train_set_size=2, batch_size=2, seed=3, task="lm", device="cpu",
                          **kw)


def test_round_cost_analysis_counts_the_round_and_leaves_the_run_unchanged():
    from p2pfl_tpu.parallel.simulation import MeshSimulation as JaxMeshSimulation

    sim = _lm_sim()
    costs = sim.round_cost_analysis(rounds_per_call=2, devobs=False)
    ref_args = inspect.signature(JaxMeshSimulation.round_cost_analysis).parameters
    args = inspect.signature(type(sim).round_cost_analysis).parameters
    assert [(n, p.default) for n, p in args.items()] == [(n, p.default) for n, p in ref_args.items()]
    assert {"flops", "flops_per_round", "bytes_accessed", "bytes_accessed_per_round"} <= set(costs)
    assert costs["flops_per_round"] == costs["flops"] / 2 > 0 and costs["bytes_accessed_per_round"] > 0
    # Attention per round: 2 members x 2 steps x 2 layers of the training
    # forward and backward pair at [2, 32, 2, 16], and 2 layers of the eval
    # forward at [2, 32, 2, 16] (eval_every=1 evaluates every round).
    b, s, h, d = 2, 32, 2, 16
    tri = b * h * s * s * d // 2
    train = 2 * 2 * 2 * (4 + 6 + 8) * tri
    assert costs["attention_flops_per_round"] == train + 2 * 4 * tri
    assert sim.completed_rounds == 0
    with_devobs = sim.round_cost_analysis(devobs=True)
    assert with_devobs["bytes_accessed"] > sim.round_cost_analysis(devobs=False)["bytes_accessed"]
    a = sim.run(rounds=2, warmup=False)
    twin = _lm_sim()
    b_ = twin.run(rounds=2, warmup=False)
    np.testing.assert_array_equal(a.committees, b_.committees)
    assert a.test_loss == b_.test_loss
    assert canonical_params_hash({k: v[0] for k, v in sim.params_stack.items()}) == canonical_params_hash(
        {k: v[0] for k, v in twin.params_stack.items()})


def test_learner_cost_analysis_keys_match_jax_and_leave_state():
    from test_torch_classification import mlp_handles, mnist_partitions

    from p2pfl_tpu.learning.learner import JaxLearner
    from p2pfl_tpu_torch.learning.learner import TorchLearner

    jparts, pparts = mnist_partitions()
    jh, ph = mlp_handles()
    ref = JaxLearner(jh, jparts[0], batch_size=4, seed=0).cost_analysis()
    learner = TorchLearner(ph, pparts[0], batch_size=4, seed=0, device="cpu")
    before = {k: v.clone() for k, v in ph.params.items()}
    got = learner.cost_analysis()
    assert set(got) == set(ref)
    assert got["steps_per_epoch"] == ref["steps_per_epoch"] >= 1
    assert got["flops_per_epoch"] > 0 and got["flops_per_step"] == pytest.approx(
        got["flops_per_epoch"] / got["steps_per_epoch"])
    assert all(torch.equal(ph.params[k], before[k]) for k in before) and learner._opt_state is None
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset

    test_only = FederatedDataset({"test": pparts[0]._split(False)})  # no train split: no cost model
    assert TorchLearner(ph, test_only, batch_size=4, seed=0, device="cpu").cost_analysis() is None
