"""The port's checkpoint store (``repro_torch.checkpoint.store``) on the
CPU, against the reference's ``repro.checkpoint.store``.

* Atomicity: a half-written ``step_XXXXXXXX.tmp`` is never listed or
  loaded; ``save_json`` never leaves a torn document.
* GC keeps the newest ``keep`` checkpoints.
* The layout is the reference's: one ``.npy`` a leaf named by its tree
  path (dict keys sorted, indices), plus ``manifest.json`` with each
  leaf's name, shape and dtype, so a tree of numpy arrays written by
  either package loads in the other, bit for bit.
* Torch leaves are saved from the host; bfloat16 round-trips through its
  uint16 bits; ``load_checkpoint`` puts every leaf on the given device.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.checkpoint import store as ref_store
from repro_torch.checkpoint import store


def tree(seed=0):
    """Nested dicts, a list and a tuple, of dtypes JAX keeps without x64
    (its ``load_checkpoint`` narrows 64-bit leaves)."""
    rng = np.random.default_rng(seed)
    return {
        "zeta": rng.standard_normal((3, 2)).astype(np.float32),
        "alpha": {"b": np.arange(4, dtype=np.int32),
                  "a": [rng.random(2).astype(np.float32), np.asarray(True)]},
        "mid": (np.uint8(7) * np.ones(16, np.uint8),
                np.asarray(5, np.int32)),
    }


def assert_tree_equal(got, want):
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_layout_is_the_reference_layout(tmp_path):
    """Same files, same manifest leaves, same bytes as the reference."""
    t = tree()
    mine = store.save_checkpoint(str(tmp_path / "port"), 3, t)
    ref = ref_store.save_checkpoint(str(tmp_path / "ref"), 3, t)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(mine, name)),
                                          np.load(os.path.join(ref, name)))
    with open(os.path.join(mine, "manifest.json")) as f:
        m = json.load(f)
    with open(os.path.join(ref, "manifest.json")) as f:
        r = json.load(f)
    assert m["step"] == r["step"] == 3
    assert m["leaves"] == r["leaves"]
    wide = {"f": np.arange(3.0), "i": np.arange(2, dtype=np.int64)}
    mine = store.save_checkpoint(str(tmp_path / "port64"), 0, wide)
    assert_tree_equal(store.load_checkpoint(str(tmp_path / "port64"), 0,
                                            wide, "cpu"), wide)
    assert "alpha__a__0" in {leaf["name"] for leaf in m["leaves"]}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_numpy_tree_crosses_packages(tmp_path, writer):
    t = tree(1)
    d = str(tmp_path)
    if writer == "reference":
        ref_store.save_checkpoint(d, 5, t)
        got = store.load_checkpoint(d, 5, t, "cpu")
        assert all(isinstance(x, torch.Tensor)
                   for x in jax.tree_util.tree_leaves(got))
    else:
        store.save_checkpoint(d, 5, t)
        got = ref_store.load_checkpoint(d, 5, t)
    assert_tree_equal(got, t)
    assert store.latest_step(d) == ref_store.latest_step(d) == 5


def test_torch_leaves_and_bfloat16_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    t = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
         "x": torch.randn(5, generator=g), "n": torch.arange(3),
         "flag": torch.tensor([True, False])}
    store.save_checkpoint(str(tmp_path), 0, t)
    back = store.load_checkpoint(str(tmp_path), 0, t, "cpu")
    for k in t:
        assert back[k].dtype == t[k].dtype
        assert torch.equal(back[k], t[k])
    with open(tmp_path / "step_00000000" / "manifest.json") as f:
        dtypes = {x["name"]: x["dtype"] for x in json.load(f)["leaves"]}
    assert dtypes["w"] == "bfloat16"


def test_tmp_checkpoint_is_never_listed(tmp_path):
    """A writer killed mid-save leaves only a ``.tmp`` directory: not a
    step, not the latest, and the next save of that step replaces it."""
    d = str(tmp_path)
    store.save_checkpoint(d, 1, tree())
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    open(os.path.join(d, "step_00000002.tmp", "zeta.npy"), "wb").close()
    assert store.all_steps(d) == [1]
    assert store.latest_step(d) == 1
    store.save_checkpoint(d, 2, tree(2))
    assert store.all_steps(d) == [1, 2]
    assert not os.path.exists(os.path.join(d, "step_00000002.tmp"))
    assert_tree_equal(store.load_checkpoint(d, 2, tree(), "cpu"), tree(2))


def test_gc_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for step in (4, 1, 9, 7, 3):
        store.save_checkpoint(d, step, {"x": np.full(2, step)}, keep=2)
    # GC runs after each save over the steps, by number: saving step 3
    # after 7 and 9 keeps 7 and 9
    assert store.all_steps(d) == [7, 9]
    for step in (10, 11, 12):
        store.save_checkpoint(d, step, {"x": np.full(2, step)}, keep=2)
    assert store.all_steps(d) == [11, 12]
    assert store.all_steps(str(tmp_path / "missing")) == []
    assert store.latest_step(str(tmp_path / "missing")) is None


def test_json_documents_are_atomic_and_cross(tmp_path):
    d = str(tmp_path)
    doc = {"banks": [{"name": "a", "capacity": 4}], "n": 3}
    store.save_json(d, "registry", doc)
    assert not os.path.exists(os.path.join(d, "registry.json.tmp"))
    assert ref_store.load_json(d, "registry") == doc
    ref_store.save_json(d, "other", doc)
    assert store.load_json(d, "other") == doc
    with pytest.raises(FileNotFoundError):
        store.load_json(d, "absent")


def test_load_puts_leaves_on_the_given_device(tmp_path):
    store.save_checkpoint(str(tmp_path), 0, {"x": np.ones(3, np.float32)})
    back = store.load_checkpoint(str(tmp_path), 0, {"x": None},
                                 torch.device("cpu"))
    assert back["x"].device.type == "cpu"
    assert back["x"].dtype == torch.float32
