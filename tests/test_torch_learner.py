"""The port's learner math and optimizers against the JAX package's.

Losses and FedProx within 1e-6 (f32, the same sums in another order);
DP-SGD with noise 0 through the ``vmap`` path and the per-example loop
within 1e-5 in the loss and 1e-5 in the gradients of a small f32 MLP; the
noise's standard deviation within 10 % of ``clip * sigma / B`` over many
draws; ``sgd`` (with and without momentum), ``adam`` and ``yogi`` within
1e-6 of optax, params and state, over 5 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.learning import learner as jax_learner
from p2pfl_tpu.models.mlp import MLP as JaxMLP
from p2pfl_tpu_torch import optim
from p2pfl_tpu_torch.learning import learner
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.models.mlp import MLP
from p2pfl_tpu_torch.models.model_handle import ModelHandle

B, CLASSES = 8, 5


def _mlp():
    jm = JaxMLP(hidden_sizes=(16, 8), out_channels=CLASSES, compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 6, 6)))
    with torch.device("meta"):
        pm = MLP(36, (16, 8), CLASSES, torch.float32)
    return jm, params, ModelHandle(flax_to_torch(params, device="cpu"), pm)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 6, 6)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=B).astype(np.int32)
    w = np.ones(B, np.float32)
    w[-2:] = 0.0  # two padded rows
    return x, y, w


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((B, CLASSES)).astype(np.float32) * 3
    _, y, w = _batch()
    got = learner.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(y), torch.from_numpy(w))
    ref = jax_learner.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6)
    zero = learner.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(y), torch.zeros(B))
    assert float(zero) == 0.0  # an all-padded batch: the denominator clamps at 1


def test_fedprox_penalty_and_grad_match_jax():
    rng = np.random.default_rng(2)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    a = {k: v + rng.standard_normal(v.shape).astype(np.float32) * 0.1 for k, v in p.items()}
    g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    tp, ta, tg = ({k: torch.from_numpy(v) for k, v in d.items()} for d in (p, a, g))
    np.testing.assert_allclose(float(learner.fedprox_penalty(tp, ta, 0.3)),
                               float(jax_learner.fedprox_penalty(p, a, 0.3)), atol=1e-6)
    ref = jax_learner.fedprox_grad(g, p, a, 0.3)
    got = learner.fedprox_grad(tg, tp, ta, 0.3)
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    # The penalty's autograd gradient is fedprox_grad's added term.
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    learner.fedprox_penalty(leaves, ta, 0.3).backward()
    for k in p:
        np.testing.assert_allclose(leaves[k].grad.numpy(), 0.3 * (p[k] - a[k]), atol=1e-6)


@pytest.mark.parametrize("per_example", ["vmap", "loop"])
@pytest.mark.parametrize("clip", [0.05, 100.0])  # clipping every example / none
def test_dp_grads_match_jax_without_noise(per_example, clip):
    jm, params, model = _mlp()
    x, y, w = _batch(3)

    def jax_loss(p, bx, by, bw):
        return jax_learner.softmax_cross_entropy(jm.apply(p, bx), by, bw)

    def port_loss(p, bx, by, bw):
        return learner.softmax_cross_entropy(model.apply(p, bx), by, bw)

    ref_loss, ref_grads = jax_learner.dp_grads(
        jax_loss, params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jax.random.key(0), clip, 0.0)
    loss, grads = learner.dp_grads(
        port_loss, model.params, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        torch.Generator().manual_seed(0), clip, 0.0, per_example)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5)
    ref_port = flax_to_torch(ref_grads, device="cpu")
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_port[k].numpy(), atol=1e-5, err_msg=k)
    if clip < 1.0:  # every example clipped: the mean's norm is at most clip
        norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
        assert float(norm) <= clip * (1 + 1e-5)


def test_dp_grads_noise_std_is_clip_sigma_over_batch():
    _, _, model = _mlp()
    x, y, _ = _batch(4)
    w = torch.ones(B)
    clip, sigma = 0.5, 1.3

    def port_loss(p, bx, by, bw):
        return learner.softmax_cross_entropy(model.apply(p, bx), by, bw)

    args = (port_loss, model.params, torch.from_numpy(x), torch.from_numpy(y), w)
    _, clean = learner.dp_grads(*args, torch.Generator().manual_seed(0), clip, 0.0)
    gen = torch.Generator().manual_seed(1)
    noise = torch.cat([
        torch.cat([(g - clean[k]).reshape(-1) for k, g in learner.dp_grads(*args, gen, clip, sigma)[1].items()])
        for _ in range(10)
    ])
    want = clip * sigma / B
    assert abs(float(noise.std()) / want - 1.0) < 0.1, (float(noise.std()), want)
    assert abs(float(noise.mean())) < 0.05 * want


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}


OPTIMIZERS = [
    ("sgd", lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
    ("sgd_momentum", lambda: optax.sgd(0.1, momentum=0.9), lambda: optim.sgd(0.1, momentum=0.9)),
    ("adam", lambda: optax.adam(0.05, b1=0.9, b2=0.99, eps=1e-3), lambda: optim.adam(0.05, b1=0.9, b2=0.99, eps=1e-3)),
    ("yogi", lambda: optax.yogi(0.05, b1=0.9, b2=0.99, eps=1e-3), lambda: optim.yogi(0.05, b1=0.9, b2=0.99, eps=1e-3)),
]


@pytest.mark.parametrize("name,make_ref,make_port", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_matches_optax_over_5_steps(name, make_ref, make_port):
    tx, opt = make_ref(), make_port()
    p_j = _tree(0)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in p_j.items()}
    s_j, s_t = tx.init(p_j), opt.init(p_t)
    for step in range(5):
        g = _tree(10 + step)
        upd, s_j = tx.update(g, s_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        upd_t, s_t = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, s_t, p_t)
        p_t = optim.apply_updates(p_t, upd_t)
    for k in p_t:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), atol=1e-6, err_msg=k)
    inner = s_j[0]
    if name == "sgd":
        assert s_t.trace is None
    elif name == "sgd_momentum":
        for k in p_t:
            np.testing.assert_allclose(s_t.trace[k].numpy(), np.asarray(inner.trace[k]), atol=1e-6)
    else:
        assert int(s_t.count) == int(inner.count) == 5
        for k in p_t:
            np.testing.assert_allclose(s_t.mu[k].numpy(), np.asarray(inner.mu[k]), atol=1e-6)
            np.testing.assert_allclose(s_t.nu[k].numpy(), np.asarray(inner.nu[k]), atol=1e-6)


def test_state_map_slices_and_writes_back_stacked_state():
    opt = optim.yogi(0.1)
    stacked = optim.state_map(lambda a: a[None].repeat((3,) + (1,) * a.dim()), opt.init(
        {k: torch.from_numpy(v) for k, v in _tree(0).items()}))
    assert stacked.count.shape == (3,) and stacked.mu["w"].shape == (3, 4, 3)
    one = optim.state_map(lambda a: a[1], stacked)
    _, new = opt.update({k: torch.ones_like(v) for k, v in one.mu.items()}, one)
    optim.state_map(lambda a, u: a[1].copy_(u), stacked, new)
    assert stacked.count.tolist() == [0, 1, 0]
    assert torch.equal(stacked.mu["b"][1], new.mu["b"]) and not torch.equal(stacked.mu["b"][0], new.mu["b"])
    assert optim.state_map(torch.clone, optim.TraceState(None)).trace is None
    with pytest.raises(TypeError):
        optim.state_map(torch.clone, [torch.zeros(1)])
