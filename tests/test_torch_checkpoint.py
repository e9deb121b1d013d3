"""Checkpoints of the PyTorch port against the reference's, on the CPU.

The port writes the reference's file format (a msgpack map from each
leaf's ``keystr`` path to ``{shape, dtype, data}``) with its own encoder:

* for the same tree the two packages write byte-identical files — at
  every header length the format has (fixmap and map16, bin8, bin16 and
  bin32, fixstr), with float32, int32, bool and bfloat16 leaves,
  a 0-d leaf, an empty one, lists and tuples;
* a file the reference wrote restores in the port (bitwise, onto the
  ``like`` tree's device) and a file the port wrote restores in the
  reference;
* a missing leaf raises ``KeyError`` and a shape mismatch ``ValueError``
  in both;
* ``save_state`` / ``restore_state`` cross both ways with the step."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt

from repro_torch import checkpoint
from repro_torch.tree import tree_leaves, tree_map


def _trees(seed=0):
    """The same tree as numpy leaves (for the reference) and tensors."""
    rng = np.random.default_rng(seed)
    bf16 = rng.normal(size=(3, 4)).astype(jnp.bfloat16)
    tree = {
        "params": {f"w{i:02d}": rng.normal(size=(i + 1, 3)).astype(
            np.float32) for i in range(17)},                    # map16
        "big": rng.normal(size=(70, 300)).astype(np.float32),   # bin32
        "mid": rng.normal(size=(40, 30)).astype(np.float32),    # bin16
        "ids": rng.integers(0, 9, (5,)).astype(np.int32),
        "mask": rng.random(6) > 0.5,
        "step": np.asarray(7, np.int32),                        # 0-d
        "empty": np.zeros((0, 4), np.float32),
        "seq": [rng.normal(size=(2,)).astype(np.float32),
                (np.float32(1.5) * np.ones((1, 1, 2), np.float32),)],
        "bf16": bf16,
    }
    ported = tree_map(_tensor, tree)
    return tree, ported


def _tensor(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _equal(port_tree, ref_tree):
    got, want = tree_leaves(port_tree), jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and str(a.dtype).split(".")[-1] == \
            b.dtype.name
        np.testing.assert_array_equal(_numpy(a), b)


def test_files_are_byte_identical_and_restore_across(tmp_path):
    tree, ported = _trees()
    mine, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "ref.ckpt")
    checkpoint.save(mine, ported)
    ref_ckpt.save(theirs, jax.tree_util.tree_map(jnp.asarray, tree))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    assert not os.path.exists(mine + ".tmp")
    _equal(checkpoint.restore(theirs, ported), tree)
    _equal(ported, ref_ckpt.restore(mine, jax.tree_util.tree_map(
        jnp.asarray, tree)))
    # restored onto the like tree's device, structure kept
    like = tree_map(lambda t: torch.zeros_like(t), ported)
    out = checkpoint.restore(mine, like)
    assert isinstance(out["seq"], list) and isinstance(out["seq"][1], tuple)
    assert all(a.device == b.device for a, b in zip(tree_leaves(out),
                                                    tree_leaves(like)))


def test_missing_leaf_and_shape_mismatch_raise_in_both(tmp_path):
    path = str(tmp_path / "a.ckpt")
    checkpoint.save(path, {"a": torch.zeros((2,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(path, {"a": torch.zeros((3,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ref_ckpt.restore(path, {"a": jnp.zeros((3,))})
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(path, {"b": torch.zeros((2,))})
    with pytest.raises(KeyError, match="missing leaf"):
        ref_ckpt.restore(path, {"b": jnp.zeros((2,))})


def test_state_envelope_crosses_both_ways(tmp_path):
    tree, ported = _trees(1)
    params, opt = tree["params"], {"m": tree["params"], "t": tree["step"]}
    p_params = ported["params"]
    p_opt = {"m": ported["params"], "t": ported["step"]}
    mine, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "ref.ckpt")
    checkpoint.save_state(mine, 42, p_params, p_opt)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    ref_ckpt.save_state(theirs, 42, to_jax(params), to_jax(opt))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    step, p, o, extra = checkpoint.restore_state(theirs, p_params, p_opt)
    assert step == 42 and extra == ()
    _equal((p, o), (params, opt))
    step, p, o, _ = ref_ckpt.restore_state(mine, to_jax(params),
                                           to_jax(opt))
    assert step == 42
    _equal((p_params, p_opt), (p, o))
