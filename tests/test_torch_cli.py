"""The port's examples (cifar, mnist), CLI and ``dryrun_multichip`` against
the JAX package's.

The examples run at tiny arguments on both sides with f32 compute
(``Settings.COMPUTE_DTYPE`` in both packages), the port's model factory
handing out the JAX package's initial weights (converted), and a committee
of the whole population whose batch is a node's whole (padded) partition,
so the two differ only in the order of their sums (the vote's order and the
shuffles come from different RNGs, and reorder members and rows only):
per-round test accuracy within 1e-5 (below one test sample in 1024).
"""

import subprocess
import sys

import numpy as np
import pytest

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.examples import EXAMPLES as JAX_EXAMPLES
from p2pfl_tpu.examples import cifar as jax_cifar
from p2pfl_tpu.examples import mnist as jax_mnist
from p2pfl_tpu_torch import cli
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.entry import dryrun_multichip
from p2pfl_tpu_torch.examples import EXAMPLES, cifar, mnist
from p2pfl_tpu_torch.learning.dataset import DirichletPartitionStrategy, synthetic_cifar10

NODES, SAMPLES = 4, 16


def _jax_weights(monkeypatch, port_module, name, jax_factory):
    """Make ``port_module.<name>`` (a model factory) return the JAX factory's
    model (same arguments, f32 compute) in the port's module, weights
    converted."""
    from p2pfl_tpu_torch.models.convert import flax_to_torch

    port_factory = getattr(port_module, name)

    def factory(*args, device="cuda", **kwargs):
        with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
            ref = jax_factory(*args, **kwargs)
        model = port_factory(*args, device=device, **kwargs)
        model.set_parameters(flax_to_torch(ref.params, device=model.device))
        return model

    monkeypatch.setattr(port_module, name, factory)


def _flags(parser_args):
    """The flags of a parser, without the help flag."""
    return sorted(a.dest for a in parser_args._actions if a.dest != "help")


def test_example_flags_match_jax_but_the_device():
    for mine, ref in ((cifar, jax_cifar), (mnist, jax_mnist)):
        assert _flags(mine.build_parser()) == sorted(
            [f for f in _flags(ref.build_parser()) if f != "platform"] + ["device"])


def test_cifar_run_tracks_jax(monkeypatch):
    """4 nodes, 2 rounds, 8 x 8 images, one label-flipped node, FedAvg (the
    undefended arm), f32: per-round test accuracy within 1e-5 and the same
    poisoned nodes."""
    data = synthetic_cifar10(n_train=NODES * SAMPLES, n_test=1024, image_size=8, seed=42)
    parts = data.generate_partitions(NODES, DirichletPartitionStrategy, alpha=0.5, min_partition_size=2)
    batch = max(len(p.export_arrays(True)[1]) for p in parts)  # one batch a node
    argv = ["--nodes", str(NODES), "--rounds", "2", "--train-set-size", str(NODES), "--samples-per-node",
            str(SAMPLES), "--batch-size", str(batch), "--image-size", "8", "--aggregator", "fedavg",
            "--poison-frac", "0.25", "--seed", "0"]
    from p2pfl_tpu.models import resnet as jax_resnet
    from p2pfl_tpu_torch.models import resnet

    _jax_weights(monkeypatch, resnet, "resnet18_model", jax_resnet.resnet18_model)
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        ref = jax_cifar.run(jax_cifar.build_parser().parse_args(argv + ["--platform", "cpu"]))
    with Settings.overridden(COMPUTE_DTYPE="float32"):
        got = cifar.run(cifar.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert set(got) == set(ref)
    for key in ("mode", "model", "aggregator", "attack", "nodes", "poisoned_nodes", "byzantine_budget"):
        assert got[key] == ref[key], key
    assert len(got["test_acc"]) == 2
    np.testing.assert_allclose(got["test_acc"], ref["test_acc"], atol=1e-5)


def test_mnist_run_mesh_tracks_jax(monkeypatch):
    from p2pfl_tpu.models import mlp as jax_mlp
    from p2pfl_tpu_torch.models import mlp

    _jax_weights(monkeypatch, mlp, "mlp_model", jax_mlp.mlp_model)
    argv = ["--nodes", str(NODES), "--rounds", "2", "--train-set-size", str(NODES), "--samples-per-node", "32",
            "--batch-size", "32", "--aggregator", "trimmed_mean", "--server-opt", "fedadam", "--seed", "0"]
    with JaxSettings.overridden(COMPUTE_DTYPE="float32"):
        ref = jax_mnist.run_mesh(jax_mnist.build_parser().parse_args(argv + ["--platform", "cpu"]))
    with Settings.overridden(COMPUTE_DTYPE="float32"):
        got = mnist.run_mesh(mnist.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert set(got) == set(ref) and got["mode"] == "mesh"
    assert abs(got["final_test_acc"] - ref["final_test_acc"]) < 1e-5


@pytest.mark.parametrize("argv,plane", [
    (["--mode", "nodes"], "Node"),
    (["--profiling"], None),
    (["--trace", "out"], None),
])
def test_mnist_options_that_wait_for_a_plane_raise(argv, plane, tmp_path, monkeypatch, capsys):
    """``--mode nodes`` runs real port Nodes now that the Node is ported
    (under the test timings), over the in-memory transport and, with
    ``--protocol grpc``, over localhost gRPC sockets (ported with the gRPC
    transport); ``--profiling`` and ``--trace DIR`` (ported with the profiler)
    write what the JAX example writes: a host ``.pstat`` under
    ``profile/mnist/`` and a trace under DIR."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--nodes", "2", "--rounds", "1", "--train-set-size", "2", "--samples-per-node", "32", "--batch-size", "32",
            "--seed", "0",
            "--device", "cpu"]
    if plane is not None:
        from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
        from p2pfl_tpu_torch.config import Settings as PortSettings
        from p2pfl_tpu_torch.utils.utils import set_test_settings

        snap = PortSettings.snapshot()
        try:
            set_test_settings()
            PortSettings.RESOURCE_MONITOR_PERIOD = 0
            assert mnist.main(argv + tiny) == 0
            assert "'mode': 'nodes'" in capsys.readouterr().out
            assert mnist.main(argv + tiny + ["--protocol", "grpc"]) == 0
            assert "'mode': 'nodes'" in capsys.readouterr().out
        finally:
            PortSettings.restore(snap)
            InMemoryRegistry.reset()
        return
    assert mnist.main(argv + tiny + ["--measure-time"]) == 0
    assert "'mode': 'mesh'" in capsys.readouterr().out
    if argv[0] == "--profiling":
        assert len(list((tmp_path / "profile" / "mnist").glob("mnist-*.pstat"))) == 1
    else:
        assert (tmp_path / "out" / "mnist" / "trace.json").is_file()


def test_cifar_cost_analysis_waits_for_the_profiler():
    """Ported with the profiler: ``--cost-analysis`` adds the round's counted
    work under the JAX example's key and keys (the bad-argument check still
    runs first)."""
    argv = ["--nodes", "2", "--rounds", "1", "--train-set-size", "2", "--samples-per-node", "8", "--batch-size",
            "8", "--image-size", "8", "--aggregator", "fedavg", "--seed", "0", "--cost-analysis"]
    got = cifar.run(cifar.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert set(got["cost_analysis"]) >= {"flops", "flops_per_round", "bytes_accessed", "bytes_accessed_per_round"}
    assert got["cost_analysis"]["flops_per_round"] > 0
    assert cifar.run(cifar.build_parser().parse_args(argv[:-1] + ["--device", "cpu"]))["cost_analysis"] is None
    with pytest.raises(SystemExit, match="poison-frac"):
        cifar.run(cifar.build_parser().parse_args(["--poison-frac", "1.5", "--device", "cpu"]))


def test_cli_lists_the_examples_and_refuses_bench(capsys):
    """The reference's examples, its two-process gRPC quickstart (node1 /
    node2) included."""
    assert set(EXAMPLES) == set(JAX_EXAMPLES)
    assert cli.main(["experiment", "list"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in EXAMPLES)
    assert cli.main(["experiment", "run", "nope"]) == 2
    with pytest.raises(NotImplementedError, match="benchmark"):
        cli.main(["bench"])


def test_cli_runs_an_example_in_a_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", "p2pfl_tpu_torch", "experiment", "run", "mnist", "--", "--device", "cpu",
         "--nodes", "2", "--rounds", "1", "--train-set-size", "2", "--samples-per-node", "64", "--seed", "0"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "'mode': 'mesh'" in proc.stdout and "final_test_acc" in proc.stdout


def test_dryrun_multichip_completes_every_phase(capsys):
    dryrun_multichip(4, device="cpu")
    lines = [line for line in capsys.readouterr().out.splitlines() if " OK" in line]
    assert [line.split(" OK")[0] for line in lines] == [
        "dryrun_multichip", "dryrun sequence-parallel", "dryrun expert-parallel", "dryrun pipeline-parallel",
        "dryrun robust-aggregation"]
