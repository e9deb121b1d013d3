"""The transformer family's building blocks in the PyTorch port against
the reference, from the same numpy inputs and carried-across weights.

* ``rmsnorm``, ``apply_rope``, ``ffn``: 2e-5 (float32; the transcendental
  functions and the summation order differ between the frameworks).
* ``tokenize``: bitwise (the same float64 numpy arithmetic).
* ``param_count`` / ``family_n_params``: equal to the reference's count,
  which prices the planner's uplink and so the host ledgers.
* ``sgd`` + ``apply_updates``, ``zero_residual`` and the parameter-tree
  helpers: bitwise.
* A config that asks for a part the port does not run (another
  ``norm_eps``, a family's field on another, MoE or MLA without their
  configs, ...) is refused by ``init`` and ``forward``.

The port's layers take a stack of N parameter copies (a leading copy
axis); the reference's take one set, so its outputs are compared with the
port's copy 0 of a one-copy stack."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import ClassificationData as RefData
from repro.fed import model_engine as ref_me
from repro.fed.train_step import zero_residual as ref_zero_residual
from repro.models import layers as ref_layers
from repro.models.model import init as ref_init
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import sgd as ref_sgd

from repro_torch.configs.base import MLAConfig, MoEConfig, SSMConfig
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import model_engine
from repro_torch.fed.train_step import zero_residual
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import layers
from repro_torch.models import model
from repro_torch.optim import apply_updates, sgd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

TOL = dict(rtol=2e-5, atol=2e-5)


def _parity(name, got, want, tol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    print(f"PARITY {name}: max_abs_err="
          f"{float(np.abs(got - want).max()):.3g} tol={tol}")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_rmsnorm_matches_reference(rng):
    x = rng.normal(size=(3, 8, 32)).astype(np.float32) * 3.0
    scale = rng.uniform(0.5, 1.5, size=32).astype(np.float32)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)[None]},
                         torch.from_numpy(x)[None])[0]
    _parity("rmsnorm", got, want)


@pytest.mark.parametrize("hd", [8, 64])
def test_apply_rope_matches_reference(rng, hd):
    x = rng.normal(size=(2, 16, 3, hd)).astype(np.float32)
    pos = np.arange(16)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0)
    _parity(f"apply_rope hd={hd}", got, want)


def test_ffn_matches_reference(rng):
    params = ref_layers.ffn_init(jax.random.key(1), 24, 48, jnp.float32)
    x = rng.normal(size=(2, 8, 24)).astype(np.float32)
    want = ref_layers.ffn(params, jnp.asarray(x))
    stacked = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a)[None], params))
    got = layers.ffn(stacked, torch.from_numpy(x)[None])[0]
    _parity("ffn (SwiGLU)", got, want)


def test_tokenize_is_bitwise_the_reference():
    for dim in (32, 6, 3072):
        data = ClassificationData.synthetic(n=50, dim=dim, seed=dim)
        rdata = RefData.synthetic(n=50, dim=dim, seed=dim)
        for got, want in zip(model_engine.tokenize(data),
                             ref_me.tokenize(rdata)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    print("PARITY tokenize (D = 32, 6, 3072): max_abs_err=0 tol=bitwise")


@pytest.mark.parametrize("hidden,depth,want", [(16, 2, None),
                                               (256, 3, 1_836_800)])
def test_param_count_matches_reference(hidden, depth, want):
    ref_count = ref_me.family_n_params("transformer", hidden, depth)
    got = model_engine.family_n_params("transformer", hidden, depth)
    assert got == ref_count
    assert want is None or got == want
    print(f"PARITY family_n_params transformer h{hidden}-d{depth}: {got} "
          f"== reference {ref_count}")
    cfg = model_engine.family_arch("transformer", hidden, depth)
    assert cfg.hd() == hidden // 4 and cfg == cfg.__class__(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_transformer_params_cross_and_step_like_the_reference():
    """Nested-dict params with stacked layers round-trip exactly, list in
    the reference's leaf order, and take the reference's SGD step."""
    cfg = ref_me.family_arch("transformer", 16, 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref_init(cfg, jax.random.key(0)))
    ported = params_from_numpy(params)
    back = params_to_numpy(ported)
    ref_leaves = jax.tree_util.tree_leaves(params)
    assert len(tree_leaves(ported)) == len(ref_leaves) == 12
    for a, b in zip(tree_leaves(back), ref_leaves):
        np.testing.assert_array_equal(a, b)
    grads = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.25, params)
    opt = ref_sgd()
    upd, _ = opt.update(grads, opt.init(params), params, 0.3)
    want = ref_apply_updates(params, upd)
    popt = sgd()
    pupd, _ = popt.update(params_from_numpy(grads), popt.init(ported),
                          ported, torch.tensor(0.3))
    got = apply_updates(ported, pupd)
    for a, b in zip(tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rebuilt = tree_unflatten(ported, tree_leaves(ported))
    assert all(a is b for a, b in zip(tree_leaves(rebuilt),
                                      tree_leaves(ported)))
    for a, b in zip(tree_leaves(params_to_numpy(zero_residual(ported))),
                    jax.tree_util.tree_leaves(ref_zero_residual(params))):
        np.testing.assert_array_equal(a, np.asarray(b))
    print("PARITY transformer params interop + sgd step + zero_residual: "
          "max_abs_err=0 tol=bitwise")


@pytest.mark.parametrize("field,value", [
    ("family", "moe"), ("attn_kind", "mla"), ("moe", object()),
    ("mla", object()), ("ssm", SSMConfig(d_state=16)), ("hybrid_every", 2),
    ("n_codebooks", 2), ("vlm_prefix", 4), ("qkv_bias", True),
    ("ffn_kind", "mlp"), ("norm_eps", 1e-6)])
def test_model_refuses_config_fields_not_ported(field, value):
    """Every field value that selects a part the port does not run is
    refused.  Some that were refused now run, each held against the
    reference elsewhere: ``qkv_bias=True`` (qwen1.5-4b,
    ``tests/test_torch_launch_train.py``), ``ffn_kind="mlp"`` (the GELU
    MLP of granite-34b, ``tests/test_torch_families.py``), the MoE family
    with a ``MoEConfig`` and MLA (``attn_kind="mla"`` with an
    ``MLAConfig``; ``tests/test_torch_moe_families.py``).  These run
    here; the family or the attention kind without its config, and a
    ``moe`` or ``mla`` that is not one, are still refused."""
    cfg = model_engine.family_arch("transformer", 16, 2)
    params = model.init(cfg, torch.Generator().manual_seed(0))
    other = dataclasses.replace(cfg, **{field: value})
    tokens = torch.zeros((1, 2, 4), dtype=torch.int64)
    logits, aux = model.forward(cfg, tree_map(lambda t: t[None], params),
                                tokens)
    assert logits.shape == (1, 2, 4, 128) and aux.shape == (1,)
    if field == "qkv_bias":
        biased = model.init(other, torch.Generator().manual_seed(0))
        assert {"bq", "bk", "bv"} <= set(biased["layers"]["attn"])
        assert model.forward(other, tree_map(lambda t: t[None], biased),
                             tokens)[0].shape == (1, 2, 4, 128)
        return
    if field == "ffn_kind":
        mlp = model.init(other, torch.Generator().manual_seed(0))
        assert set(mlp["layers"]["ffn"]) == {"w_up", "w_down"}
        assert model.forward(other, tree_map(lambda t: t[None], mlp),
                             tokens)[0].shape == (1, 2, 4, 128)
        return
    moe = {"family": "moe", "moe": MoEConfig(n_experts=4, top_k=2,
                                               d_ff_expert=8)}
    mla = {"attn_kind": "mla", "mla": MLAConfig(
        kv_lora_rank=8, q_lora_rank=None, qk_nope_head_dim=4,
        qk_rope_head_dim=4, v_head_dim=4)}
    ported = {"family": moe, "moe": moe, "attn_kind": mla, "mla": mla}
    if field in ported:
        runs = dataclasses.replace(cfg, **ported[field])
        p = model.init(runs, torch.Generator().manual_seed(0))
        assert set(p["layers"]) >= ({"moe"} if "moe" in ported[field]
                                    else {"ffn"})
        logits, aux = model.forward(runs, tree_map(lambda t: t[None], p),
                                    tokens,
                                    rt=model.Runtime(attn_impl="naive"))
        assert logits.shape == (1, 2, 4, 128) and bool(
            torch.isfinite(logits).all())
        assert bool(aux > 0) == (runs.family == "moe")
    with pytest.raises(NotImplementedError, match="not ported"):
        model.init(other, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="not ported"):
        model.forward(other, tree_map(lambda t: t[None], params), tokens)
