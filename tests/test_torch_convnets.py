"""The port's convnets (CNN, GroupNorm ResNet-18) against the JAX package's:
weight conversion, wire frames, forwards and federated rounds.

Same inputs (numpy, from a seed) go through the flax modules and the port's,
on weights carried across with ``p2pfl_tpu_torch.models.convert``.
Tolerances: f32 forwards 1e-5; bf16 forwards a bar from bf16 rounding at
the logits' scale (stated at the test); the CNN round 1e-5 in test loss,
accuracy and node 0's parameters under SGD (both sides f32, one batch a
node, so they differ only in the order of their sums); Adam's and the
ResNet round's bars are stated at their tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as JaxRandomIID
from p2pfl_tpu.learning.dataset import poison_partitions as jax_poison_partitions
from p2pfl_tpu.learning.dataset import synthetic_cifar10 as jax_synthetic_cifar10
from p2pfl_tpu.models import cnn as jax_cnn
from p2pfl_tpu.models import resnet as jax_resnet
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle
from p2pfl_tpu.ops import aggregation as jax_agg
from p2pfl_tpu_torch.learning.dataset import (
    RandomIIDPartitionStrategy,
    poison_partitions,
    synthetic_cifar10,
    synthetic_mnist,
)
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.models import cnn, resnet
from p2pfl_tpu_torch.models.convert import flax_to_torch, from_canonical, to_canonical, torch_to_flax
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import aggregation as agg
from test_torch_classification import assert_matches, mnist_partitions, node_params, run_pair

IMG = 8  # ResNet-18 at full depth and width on 8 x 8 images


def cnn_handles(compute=(jnp.float32, torch.float32), seed=0, shape=(28, 28, 1)):
    """The JAX and port handles of one CNN on the same flax weights."""
    jm = jax_cnn.CNN(out_channels=10, compute_dtype=compute[0])
    params = jm.init(jax.random.key(seed), jnp.zeros((1, *shape)))
    with torch.device("meta"):
        pm = cnn.CNN(shape[2], shape[:2], 10, compute[1])
    return (JaxModelHandle(params=params, apply_fn=jm.apply, model_def=jm),
            ModelHandle(flax_to_torch(params, device="cpu"), pm))


def resnet_handles(compute=(jnp.float32, torch.float32), seed=0, stage_sizes=(2, 2, 2, 2), classes=10):
    """The JAX and port handles of one GroupNorm ResNet on the same flax weights."""
    jm = jax_resnet.ResNet18(out_channels=classes, stage_sizes=stage_sizes, compute_dtype=compute[0])
    params = jm.init(jax.random.key(seed), jnp.zeros((1, IMG, IMG, 3)))
    with torch.device("meta"):
        pm = resnet.ResNet18(3, classes, stage_sizes, compute[1])
    return (JaxModelHandle(params=params, apply_fn=jm.apply, model_def=jm),
            ModelHandle(flax_to_torch(params, device="cpu"), pm))


def _inputs(kind, b=4, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, 28, 28) if kind == "cnn" else (b, IMG, IMG, 3)
    return rng.uniform(0.0, 1.0, shape).astype(np.float32)


HANDLES = {"cnn": cnn_handles, "resnet": resnet_handles}


@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_conv_and_groupnorm_weights_round_trip_exactly(kind):
    """flax -> port -> flax and canonical -> port -> canonical are exact; the
    canonical leaves are the JAX package's (flax order, HWIO conv kernels,
    GroupNorm scales as ``scale``)."""
    jh, ph = HANDLES[kind]()
    back = torch_to_flax(ph.params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jh.params)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jh.params))
    leaves = to_canonical(ph.params)
    for got, want in zip(leaves, jh.get_parameters()):
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    again = from_canonical(list(ph.params), leaves)
    assert all(torch.equal(again[n], t) for n, t in ph.params.items())
    if kind == "resnet":  # conv weights OIHW, GroupNorm scales under "weight"
        assert ph.params["Conv_0.weight"].shape == (64, 3, 3, 3)
        assert "GroupNorm_0.weight" in ph.params and "scale" in back["params"]["GroupNorm_0"]


@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_convnet_frames_are_the_jax_frames(kind):
    """A converted model's PFLT frame has the reference's bytes, and each
    package adopts the other's frame."""
    jh, ph = HANDLES[kind]()
    ph.set_contribution(["p"], 7)
    frame = ph.encode_parameters(compression="none")
    assert frame == bytes(jh.build_copy(contributors=["p"], num_samples=7).encode_parameters(compression="none"))
    fresh_jax = HANDLES[kind](seed=1)[0]
    fresh_jax.set_parameters(frame)
    for got, want in zip(fresh_jax.get_parameters(), jh.get_parameters()):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    fresh = HANDLES[kind](seed=2)[1]
    fresh.set_parameters(bytes(jh.encode_parameters(compression="none")))
    assert all(torch.equal(fresh.params[n], t) for n, t in ph.params.items())


# bf16 bars: each layer rounds its output to bf16 (2^-8 relative); the CNN's
# four layers and the ResNet's 18 GroupNorm-renormalised layers accumulate
# a few such roundings, taken here as 2^-5 (CNN) and 2^-3 (ResNet) of the
# largest logit.
@pytest.mark.parametrize(
    "kind,dtypes,bar",
    [("cnn", (jnp.float32, torch.float32), None), ("cnn", (jnp.bfloat16, torch.bfloat16), 2.0 ** -5),
     ("resnet", (jnp.float32, torch.float32), None), ("resnet", (jnp.bfloat16, torch.bfloat16), 2.0 ** -3)],
    ids=["cnn-f32", "cnn-bf16", "resnet-f32", "resnet-bf16"],
)
def test_convnet_logits_match_jax(kind, dtypes, bar):
    jh, ph = HANDLES[kind](dtypes)
    x = _inputs(kind)
    ref = np.asarray(jh.apply_fn(jh.params, jnp.asarray(x)))
    with torch.no_grad():
        out = ph.apply(ph.params, torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    atol = 1e-5 if bar is None else bar * float(np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0)


def test_same_padding_at_stride_two_is_asymmetric():
    """flax SAME at stride 2 on an even side pads (0, 1): torch's padding=1
    differs, the port's ``conv_same`` does not."""
    jm = jax_resnet.BasicBlock(8, (2, 2), jnp.float32)
    x = _inputs("resnet", b=2)[..., :3]
    x = np.concatenate([x, x[..., :3], x[..., :2]], axis=-1)  # 8 channels
    params = jm.init(jax.random.key(3), jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.device("meta"):
        pm = resnet.BasicBlock(8, 8, (2, 2), torch.float32)
    p = flax_to_torch(params, device="cpu")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = torch.func.functional_call(pm, p, (xt,)).permute(0, 2, 3, 1)
        sym = torch.nn.functional.conv2d(xt, p["Conv_0.weight"], None, 2, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    same = resnet.conv_same(xt, torch.nn.Conv2d(8, 8, 3, 2, bias=False).requires_grad_(False), torch.float32)
    assert same.shape == sym.shape == (2, 8, 4, 4)
    with torch.no_grad():
        asym = resnet.conv_same(xt, _conv_with(p["Conv_0.weight"], 2), torch.float32)
    assert float((asym - sym).abs().max()) > 1e-2


def _conv_with(weight, stride):
    conv = torch.nn.Conv2d(weight.shape[1], weight.shape[0], weight.shape[2], stride, bias=False)
    conv.weight.data.copy_(weight)
    return conv


def test_synthetic_cifar10_and_poisoning_equal_jax():
    kw = dict(n_train=64, n_test=16, num_classes=4, image_size=IMG, seed=42)
    mine, ref = synthetic_cifar10(**kw), jax_synthetic_cifar10(**kw)
    for train in (True, False):
        for a, b in zip(mine.export_arrays(train), ref.export_arrays(train)):
            np.testing.assert_array_equal(a, b)
    parts, poisoned = poison_partitions(mine.generate_partitions(8, RandomIIDPartitionStrategy), 0.25, 4, seed=7)
    rparts, rpoisoned = jax_poison_partitions(ref.generate_partitions(8, JaxRandomIID), 0.25, 4, seed=7)
    np.testing.assert_array_equal(poisoned, rpoisoned)
    for p, r in zip(parts, rparts):
        for a, b in zip(p.export_arrays(True), r.export_arrays(True)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_cnn_round_matches_jax(opt):
    """4 nodes, a shared committee schedule, 2 rounds, f32: test loss and
    accuracy within 1e-5 under either optimizer; node 0's parameters within
    1e-5 under SGD. Under Adam (the default) the bar on parameters is 1e-4,
    a tenth of lr: the loss gradients agree within ~1e-7 absolute, but Adam
    divides each gradient by its own magnitude, so where |g| is ~1e-7 that
    noise becomes a relative error of the step (measured 1.2e-5 here)."""
    sched = np.array([[0, 2], [1, 3]], np.int32)
    kw = {}
    if opt == "sgd":
        import optax

        from p2pfl_tpu_torch.optim import sgd

        kw = dict(jax_kwargs=dict(optimizer=optax.sgd(0.05)), port_kwargs=dict(optimizer=sgd(0.05)))
    jsim, ref, sim, res = run_pair(sched, handles=cnn_handles(), partitions=mnist_partitions(4), **kw)
    np.testing.assert_allclose(res.test_loss, ref.test_loss, atol=1e-5)
    assert_matches(jsim, ref, sim, res, atol=1e-5 if opt == "sgd" else 1e-4)


def test_resnet_gradients_match_jax():
    """Full-depth ResNet-18, f32, 16 images of 8 x 8: the loss within 1e-5
    and every leaf's gradient within 1e-5 of that leaf's largest gradient
    (measured 2.2e-6)."""
    from p2pfl_tpu.learning.learner import softmax_cross_entropy as jax_ce
    from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy

    jh, ph = resnet_handles(classes=4)
    x, y = synthetic_cifar10(n_train=16, n_test=4, num_classes=4, image_size=IMG).export_arrays(True)
    w = np.ones(len(y), np.float32)
    ref_loss, ref = jax.value_and_grad(
        lambda p: jax_ce(jh.apply_fn(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(w)))(jh.params)
    params = {k: v.clone().requires_grad_(True) for k, v in ph.params.items()}
    loss = softmax_cross_entropy(ph.apply(params, torch.from_numpy(x)), torch.from_numpy(y).long(),
                                 torch.from_numpy(w))
    grads = torch_to_flax(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
    assert abs(float(loss.detach()) - float(ref_loss)) < 1e-5
    for got, want in zip(jax.tree.leaves(grads), jax.tree.leaves(ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=0)


def test_resnet_round_under_poisoning_and_krum_matches_jax():
    """The reference's federated ResNet form (label-flipped partitions,
    Krum) at 4 nodes and one round, f32, full-depth ResNet-18 on 8 x 8
    images of 4 classes. Krum runs with f = 0 (with f = 1 over 4 members
    two members tie to f32 noise, tests/test_torch_sim_robust.py).

    Bars: accuracy within 1e-5, test loss within 1e-4 (measured 1e-5), and
    node 0's parameters within 1e-2 of the round's update in L2 norm, the
    bar of the card-against-CPU round check in ``chip_smoke.py``. Not per
    element: the gradients agree (``test_resnet_gradients_match_jax``), but
    Adam's first step is ``lr * g / (|g| + eps)``, so a gradient of ~1e-7
    whose last digits differ moves its weight by up to a fraction of lr
    (measured 6.6e-4 on one element, lr 1e-3)."""
    kw = dict(n_train=4 * 16, n_test=32, num_classes=4, image_size=IMG, seed=42)
    jparts, _ = jax_poison_partitions(
        jax_synthetic_cifar10(**kw).generate_partitions(4, JaxRandomIID), 0.25, num_classes=4, seed=7)
    pparts, poisoned = poison_partitions(
        synthetic_cifar10(**kw).generate_partitions(4, RandomIIDPartitionStrategy), 0.25, num_classes=4, seed=7)
    assert len(poisoned) == 1
    handles = resnet_handles(classes=4)
    start = jax.tree.leaves(jax.tree.map(np.asarray, handles[0].params))
    sched = np.array([[0, 1, 2, 3]], np.int32)
    jsim, ref, sim, res = run_pair(
        sched, handles=handles, partitions=(jparts, pparts), batch_size=16,
        jax_kwargs=dict(aggregate_fn=lambda s, w: jax_agg.krum(s, w, num_byzantine=0, num_selected=2)[0]),
        port_kwargs=dict(aggregate_fn=lambda s, w: agg.krum(s, w, num_byzantine=0, num_selected=2)[0]),
    )
    np.testing.assert_array_equal(res.committees, np.asarray(ref.committees))
    np.testing.assert_allclose(res.test_acc, ref.test_acc, atol=1e-5)
    np.testing.assert_allclose(res.test_loss, ref.test_loss, atol=1e-4)
    got, want = (jax.tree.leaves(t) for t in node_params(jsim, sim))
    gap = np.sqrt(sum(float(np.sum((a - b) ** 2)) for a, b in zip(got, want)))
    update = np.sqrt(sum(float(np.sum((b - s) ** 2)) for b, s in zip(want, start)))
    assert update > 0 and gap < 1e-2 * update, (gap, update)


def test_torch_learner_fits_the_cnn():
    """The port's counterpart of the reference's CNN learner test: 4 epochs
    on 512 synthetic MNIST samples lift test accuracy above 0.5."""
    data = synthetic_mnist(n_train=512, n_test=64)
    learner = TorchLearner(cnn.cnn_model(seed=0, device="cpu"), data, "cnn0", batch_size=32, lr=3e-3,
                           seed=0, device="cpu")
    learner.set_epochs(4)
    learner.fit()
    metrics = learner.evaluate()
    assert metrics["test_acc"] > 0.5, metrics
