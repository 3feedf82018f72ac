"""The port's sharding rules and cell layouts (``repro_torch.launch.
sharding`` and ``.specs``) against the reference's, computed live.

* Every weight of every registered arch (the full configs and the smoke
  ones): ``make_param_shardings`` (``fit_spec(param_spec(...))``) at the
  production extents ``16 × 16`` over ``(data, model)`` and ``2 × 16 ×
  16`` over ``(pod, data, model)`` and at ``(2, 2)``, name for name
  (``convert.lm_named``'s mapping), the port's spec the reference's
  without the stacked group axis.  The reference's functions read only
  a mesh's ``axis_names`` and ``shape``: a ``jax.sharding.AbstractMesh``
  stands in for the devices.
* Every arch × ``SHAPES``: ``batch_specs``' shapes and dtypes against
  ``jax.eval_shape`` of the reference's, cache by cache (the port's
  per-layer caches against the reference's stacked groups), and
  ``make_batch_shardings`` (``_cache_leaf_spec`` for the caches) at the
  three extents.
* ``fit_spec``'s fallback (mamba2's vocabulary of 50280 over 16),
  ``spec_for``'s table and ``mesh_context``'s roles, ``local_block`` /
  ``block_slices`` cutting a full tensor into blocks that tile it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config, list_archs
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models.lm import model as JM
from repro_torch import convert
from repro_torch.core.runtime import make_mesh
from repro_torch.launch import sharding, specs
from repro_torch.models.lm import model as TM

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
ARCHS = list_archs()


class _Held:
    """A spec in a slot of a numpy object array (``convert.lm_named``
    indexes the stacked groups' leaves)."""

    def __init__(self, spec):
        self.spec = spec


def _unheld(x):
    return (x.item() if isinstance(x, np.ndarray) else x).spec


def _ref_named_specs(jcfg, shape, names) -> dict:
    """The reference's fitted spec of every weight, by the port's name,
    its stacked group axis dropped."""
    params = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    mesh = AbstractMesh(shape, names)
    shard = jsharding.make_param_shardings(mesh, params)
    stacked = {id(x) for x in jax.tree_util.tree_leaves(
        params.get("blocks", {}))}

    def hold(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        if id(leaf) in stacked:
            assert spec[0] is None
            arr = np.empty(leaf.shape[0], dtype=object)
            for i in range(leaf.shape[0]):
                arr[i] = _Held(spec[1:])
            return arr
        return _Held(spec)

    held = jax.tree_util.tree_map(hold, params, shard)
    return {n: _unheld(x) for n, x in convert.lm_named(held).items()}


def _cfgs(arch, smoke):
    jcfg = get_config(arch, smoke=smoke)
    return jcfg, convert.arch_config(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    shape, names = MESHES[mesh]
    for smoke in (False, True):
        jcfg, tcfg = _cfgs(arch, smoke)
        want = _ref_named_specs(jcfg, shape, names)
        model = TM.init_params(tcfg, 0, device="meta", dtype=torch.float32)
        got = sharding.make_param_shardings(make_mesh(shape, names), model)
        assert sorted(got) == sorted(want), (arch, smoke)
        for name in want:
            assert got[name] == want[name], (arch, smoke, name)


def test_fit_spec_fallbacks():
    """mamba2's vocabulary of 50280 stays whole over a 16-way ``model``
    (its D dim takes the batch axes); an axis the grid lacks is dropped;
    an axis of one divides everything."""
    tcfg = convert.arch_config(dataclasses.asdict(get_config("mamba2-1.3b")))
    model = TM.init_params(tcfg, 0, device="meta", dtype=torch.float32)
    assert tuple(model.embed.shape) == (50280, 2048)
    for mesh, want in (("16x16", (None, "data")),
                       ("2x16x16", (None, ("pod", "data")))):
        got = sharding.make_param_shardings(make_mesh(*MESHES[mesh]), model)
        assert got["embed"] == want
        ref = jsharding.fit_spec(
            jsharding.param_spec("embed", (50280, 2048),
                                 AbstractMesh(*MESHES[mesh])),
            (50280, 2048), AbstractMesh(*MESHES[mesh]))
        assert tuple(ref) == want
    grid = make_mesh((4,), ("data",))
    assert sharding.fit_spec(("model", "data"), (6, 8), grid) == (None,
                                                                  "data")
    assert sharding.fit_spec(("model", "data"), (6, 6), grid) == (None,
                                                                  None)
    one = make_mesh((1, 1), ("data", "model"))
    assert sharding.fit_spec(("data", "model"), (3, 5), one) == ("data",
                                                                 "model")


def _ref_layer_caches(caches, layouts) -> list:
    """The reference's caches as one dict a layer, in depth order: each
    leaf's ``(shape, dtype, stacked, layout)``, ``stacked`` marking the
    scanned groups' leading group axis."""
    def entry(v, sh, stacked):
        return (tuple(v.shape), v.dtype, stacked, sh)

    out = [{k: entry(v, sh[k], False) for k, v in layer.items()}
           for layer, sh in zip(caches.get("head_blocks", []),
                                layouts.get("head_blocks", []))]
    blocks = caches.get("blocks", {})
    names = sorted(blocks, key=lambda k: int(k[1:k.index("_")]))
    if names:
        groups = jax.tree_util.tree_leaves(blocks)[0].shape[0]
        for _ in range(groups):
            for name in names:
                out.append({k: entry(v, layouts["blocks"][name][k], True)
                            for k, v in blocks[name].items()})
    out += [{k: entry(v, sh[k], False) for k, v in layer.items()}
            for layer, sh in zip(caches.get("tail_blocks", []),
                                 layouts.get("tail_blocks", []))]
    return out


def _dtype(name) -> torch.dtype:
    return {"int32": torch.int32, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[str(name)]


@pytest.mark.parametrize("shape_name", list(specs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_layouts_match_reference(arch, shape_name):
    jcfg, tcfg = _cfgs(arch, False)
    want = jspecs.batch_specs(jcfg, shape_name)
    got = specs.batch_specs(tcfg, shape_name)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "caches":
            continue
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == _dtype(want[k].dtype), k
        assert got[k].device.type == "meta"
    for mesh in MESHES.values():
        jmesh = AbstractMesh(*mesh)
        w = jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                   jspecs.make_batch_shardings(want, jcfg,
                                                               jmesh))
        g = specs.make_batch_shardings(got, tcfg, make_mesh(*mesh))
        for k in want:
            if k != "caches":
                assert g[k] == w[k], (k, mesh)
        ref_layers = _ref_layer_caches(want.get("caches", {}),
                                       w.get("caches", {}))
        got_layers = got.get("caches", [])
        assert len(got_layers) == len(ref_layers)
        for ref, layer, lay in zip(ref_layers, got_layers,
                                   g.get("caches", [])):
            assert sorted(layer) == sorted(ref)
            for k, (shape, dtype, stacked, spec) in ref.items():
                assert tuple(layer[k].shape) == shape[int(stacked):], k
                assert layer[k].dtype == _dtype(dtype), k
                spec = spec + (None,) * (len(shape) - len(spec))
                assert lay[k] == spec[int(stacked):], (k, mesh)
                assert specs._cache_leaf_spec(
                    k, shape[int(stacked):], tcfg, make_mesh(*mesh)) \
                    == lay[k]


def test_cell_shardings_and_param_opt_specs():
    """A train cell's layouts: weights by name (the moments the same, the
    step replicated), batch leaves over the batch axes; nothing is
    allocated."""
    tcfg = convert.arch_config(dataclasses.asdict(get_config("qwen3-32b")))
    grid = make_mesh(*MESHES["16x16"])
    (p_sh, o_sh, b_sh), (params, opt, batch) = specs.cell_shardings(
        tcfg, "train_4k", grid)
    assert params.embed.device.type == "meta"
    assert params.embed.dtype == torch.float32
    assert o_sh == {"m": p_sh, "v": p_sh, "step": ()}
    assert opt["m"]["embed"].shape == params.embed.shape
    assert b_sh["tokens"] == ("data", None)
    assert tuple(batch["tokens"].shape) == (256, 4096)
    assert p_sh["blocks.0.attn.wq"] == ("data", "model")
    (p2, b2), (_, batch2) = specs.cell_shardings(tcfg, "long_500k", grid)
    assert b2["pos"] == () and b2["tokens"] == (None, None)
    assert specs.token_shape(tcfg, 2, 3) == (2, 3)
    _, opt16 = specs.param_and_opt_specs(tcfg, True, moments_bf16=True)
    assert opt16["v"]["embed"].dtype == torch.bfloat16
    assert specs.TRAIN_MICROBATCHES == jspecs.TRAIN_MICROBATCHES
    assert specs.SHAPES == jspecs.SHAPES


def test_spec_for_and_roles():
    """Outside a grid no kind has a layout; inside, the reference's table
    with the grid's batch axes (a tuple with a pod axis)."""
    assert sharding.spec_for("act") is None
    assert sharding.active_mesh() is None
    with sharding.mesh_context(make_mesh(*MESHES["16x16"])) as g:
        assert sharding.active_mesh() is g
        assert sharding.spec_for("act") == ("data", None, None)
        assert sharding.spec_for("logits") == ("data", None, "model")
        assert sharding.spec_for("moe_buf_f") == ("data", None, "model")
        assert sharding.spec_for("nothing") is None
        assert sharding.param_spec("blocks.0.mlp.w_up", (4, 8)) == (
            "data", "model")
    with sharding.mesh_context(make_mesh(*MESHES["2x16x16"])):
        assert sharding.spec_for("batch_seq") == (("pod", "data"), None)
        assert sharding.param_spec("embed", (8, 4)) == ("model",
                                                        ("pod", "data"))
    assert sharding.active_mesh() is None


def test_local_blocks_tile_the_full_tensor():
    """The blocks of every rank of a ``(2, 2, 2)`` grid tile a full
    tensor exactly once, a dim over ``(pod, data)`` split row-major."""
    grid = make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    spec = (("pod", "data"), "model")
    seen = torch.zeros_like(x)
    for coords in np.ndindex(2, 2, 2):
        blk = sharding.local_block(x, spec, grid, coords)
        sl = sharding.block_slices(spec, x.shape, grid, coords)
        assert torch.equal(blk, x[sl]) and blk.shape == (2, 3)
        assert blk.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
        seen[sl] += 1
        assert sl[0].start == (coords[0] * 2 + coords[1]) * 2
    assert torch.equal(seen, torch.ones_like(x))
    arr = np.arange(12).reshape(4, 3)
    assert np.array_equal(sharding.local_block(arr, ("data", None),
                                               make_mesh((2,), ("data",)),
                                               (1,)), arr[2:])
