"""The port's aggregation rules against ``p2pfl_tpu/ops/aggregation.py`` on
the same random f32 stacks: every rule within 1e-5, Krum's selected indices
exactly equal (the inputs are continuous random draws, so no two scores
tie).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.ops import aggregation as ref
from p2pfl_tpu_torch.ops import aggregation as agg

TOL = 1e-5


def _stack(n, seed=0, outliers=0):
    rng = np.random.default_rng(seed)
    s = {"a": rng.standard_normal((n, 6, 3)).astype(np.float32),
         "b": rng.standard_normal((n, 5)).astype(np.float32)}
    for i in range(outliers):  # far-away models, as a Byzantine member's
        s["a"][i] += 8.0
        s["b"][i] -= 8.0
    return s


def _weights(n, seed=1):
    return np.random.default_rng(seed).integers(1, 50, size=n).astype(np.float32)


def _port(stack):
    return {k: torch.from_numpy(v.copy()) for k, v in stack.items()}


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, err_msg=k)


def test_tree_stack_and_unstack_round_trip():
    trees = [{"a": torch.full((2,), float(i)), "b": torch.arange(3.0) + i} for i in range(4)]
    stacked = agg.tree_stack(trees)
    ref_stacked = ref.tree_stack([{k: v.numpy() for k, v in t.items()} for t in trees])
    _close(stacked, ref_stacked, 0.0)
    back = agg.tree_unstack(stacked, 4)
    for t, b in zip(trees, back):
        for k in t:
            assert torch.equal(t[k], b[k])


@pytest.mark.parametrize("n", [3, 4])
def test_fedavg_masked_and_fedmedian_match_jax(n):
    s, w = _stack(n), _weights(n)
    mask = np.array([1, 0, 1, 1][:n], np.float32)
    _close(agg.fedavg_masked(_port(s), torch.from_numpy(w), torch.from_numpy(mask)),
           ref.fedavg_masked(s, jnp.asarray(w), jnp.asarray(mask)))
    _close(agg.fedmedian(_port(s)), ref.fedmedian(s))  # odd and even counts


@pytest.mark.parametrize("trim", [0, 1, 2])
def test_trimmed_mean_matches_jax(trim):
    s = _stack(5, outliers=1)
    _close(agg.trimmed_mean(_port(s), trim), ref.trimmed_mean(s, trim))
    with pytest.raises(ValueError, match="trim"):
        agg.trimmed_mean(_port(s), 3)


@pytest.mark.parametrize("num_byzantine,num_selected", [(1, 1), (1, 3), (2, 2)])
def test_krum_matches_jax(num_byzantine, num_selected):
    s, w = _stack(7, seed=3, outliers=num_byzantine), _weights(7)
    idx = agg.krum_select(_port(s), num_byzantine, num_selected)
    ref_idx = ref.krum_select(s, num_byzantine, num_selected)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert not set(idx.tolist()) & set(range(num_byzantine))  # the outliers are never selected
    out, out_idx = agg.krum(_port(s), torch.from_numpy(w), num_byzantine, num_selected)
    ref_out, ref_out_idx = ref.krum(s, jnp.asarray(w), num_byzantine, num_selected)
    np.testing.assert_array_equal(out_idx.numpy(), np.asarray(ref_out_idx))
    _close(out, ref_out)


@pytest.mark.parametrize("iters", [1, 8])
def test_geometric_median_matches_jax(iters):
    s, w = _stack(6, seed=5, outliers=2), _weights(6)
    _close(agg.geometric_median(_port(s), torch.from_numpy(w), iters=iters),
           ref.geometric_median(s, jnp.asarray(w), iters=iters))


def test_sparse_delta_apply_matches_jax():
    rng = np.random.default_rng(6)
    anchor = rng.standard_normal(50).astype(np.float32)
    idx = np.array([3, 7, 7, 49, 0], np.int32)  # a repeated index adds up
    vals = rng.standard_normal(5).astype(np.float32)
    got = agg.sparse_delta_apply(torch.from_numpy(anchor), torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.sparse_delta_apply(anchor, idx, vals)), atol=TOL)
    assert torch.equal(torch.from_numpy(anchor), torch.from_numpy(anchor.copy()))  # not in place


def test_scaffold_update_matches_jax():
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((6, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    c = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    dy, dc = _stack(4, seed=8), _stack(4, seed=9)
    dy = {"a": dy["a"], "b": dy["b"]}
    got_p, got_c = agg.scaffold_update(_port(params), _port(c), _port(dy), _port(dc), 0.7, 10.0)
    ref_p, ref_c = ref.scaffold_update(params, c, dy, dc, jnp.float32(0.7), jnp.float32(10.0))
    _close(got_p, ref_p)
    _close(got_c, ref_c)
