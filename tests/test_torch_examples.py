"""The port's ``examples/longcontext.py`` and ``entry()`` against the JAX
package's.

longcontext runs at a tiny size with every node elected every round and one
batch per node (the two frameworks' votes and shuffles then cannot differ in
what they train on), both sides on the same f32-compute flash LM (the model
factories are patched in the test to the same JAX weights). The printed
losses agree to the LM round's tolerance (1e-5, tests/test_torch_simulation.py)
plus one unit of the example's last printed digit (it rounds to 4 places).
``entry()``'s forward runs bf16 compute on both sides: on its zero batch
5e-2, the port's bf16 tolerance; on a seeded random batch one bf16 ulp of
the largest logit.
"""

import ast
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p2pfl_tpu.models as jax_models
from p2pfl_tpu.examples import longcontext as jax_longcontext
from p2pfl_tpu.models.model_handle import ModelHandle as JaxModelHandle
from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from p2pfl_tpu_torch.entry import entry
from p2pfl_tpu_torch.examples import longcontext
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import TransformerLM

ARGS = ["--nodes", "4", "--train-set-size", "4", "--seqs-per-node", "4", "--batch-size", "4", "--seq-len", "16",
        "--vocab", "32", "--layers", "1", "--heads", "2", "--embed-dim", "32", "--rounds", "2",
        "--attention", "flash", "--platform", "cpu"]


def test_longcontext_matches_the_jax_example(monkeypatch, capsys):
    kw = dict(vocab_size=32, num_layers=1, num_heads=2, embed_dim=32, attention_kind="flash")
    jax_module = JaxTransformerLM(**kw, compute_dtype=jnp.float32)
    params = jax_module.init(jax.random.key(0), jnp.zeros((1, 16), jnp.int32))
    with torch.device("meta"):
        port_module = TransformerLM(**kw, compute_dtype=torch.float32)
    monkeypatch.setattr(jax_models, "transformer_lm_model",
                        lambda **_: JaxModelHandle(params=params, apply_fn=jax_module.apply, model_def=jax_module))
    monkeypatch.setattr(longcontext, "transformer_lm_model",
                        lambda **a: ModelHandle(flax_to_torch(params, device=a["device"]), port_module))
    printed = []
    for main in (jax_longcontext.main, longcontext.main):
        assert main(ARGS) == 0
        printed.append(ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1]))
    ref, got = printed
    assert set(got) == set(ref)
    assert got["seq_len"] == 16 and got["attention"] == "flash"
    for key in ("first_token_loss", "final_token_loss", "final_token_acc"):
        assert abs(got[key] - ref[key]) <= 1e-4 + 1e-5, (key, got[key], ref[key])
    assert got["final_token_loss"] < got["first_token_loss"]


def test_longcontext_flags_defaults_and_dp():
    parser, ref_parser = longcontext.build_parser(), jax_longcontext.build_parser()
    got, ref = vars(parser.parse_args([])), vars(ref_parser.parse_args([]))
    assert set(got) == set(ref) and all(got[k] == ref[k] for k in got)
    assert parser.parse_args(["--platform", "cuda"]).platform == "cuda"
    with pytest.warns(UserWarning, match="pinned seed"):  # the example pins --seed, as the JAX one does
        res = longcontext.run(parser.parse_args(ARGS[:-4] + ["--dp-clip", "1.0", "--dp-noise", "0.5", "--rounds",
                                                              "1", "--platform", "cpu", "--measure-time"]))
    assert res["dp_epsilon_at_1e-5"] > 0 and res["total_elapsed_s"] > 0


def test_entry_matches_graft_entry_on_converted_weights():
    graft = importlib.import_module("__graft_entry__")
    jax_fwd, (jax_params, jax_x) = graft.entry()
    fwd, (params, x) = entry(device="cpu")
    assert x.shape == (64, 28, 28) and x.dtype == torch.float32 and not x.any()
    ref = np.asarray(jax_fwd(jax_params, jax_x))
    assert ref.shape == (64, 10)
    out = fwd(flax_to_torch(jax_params, device="cpu"), torch.from_numpy(np.array(jax_x)))
    assert out.shape == (64, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=5e-2, rtol=0)
    assert torch.isfinite(fwd(params, x)).all()
    # The zero batch meets zero biases, so it holds no weight: a seeded
    # random batch gives logits of real size (|logit| up to ~1.5), held to
    # one bf16 ulp of the largest.
    xr = np.random.default_rng(0).normal(size=(64, 28, 28)).astype(np.float32)
    ref = np.asarray(jax_fwd(jax_params, jnp.asarray(xr)))
    scale = float(np.abs(ref).max())
    assert scale > 0.5
    out = fwd(flax_to_torch(jax_params, device="cpu"), torch.from_numpy(xr))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2.0 ** (np.floor(np.log2(scale)) - 7), rtol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
