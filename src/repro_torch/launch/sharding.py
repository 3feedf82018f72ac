"""Sharding rules and the LM's placements over a process grid (port of
``repro.launch.sharding``).

The reference names no mesh axis in its model code: it calls
``constrain(x, KIND)`` with a logical kind that this module resolves for
the active mesh (``(data, model)``, or ``(pod, data, model)``), and GSPMD
places the rest.  The port has no partitioner, so the placements and the
collectives are explicit:

* **Parameters**: every weight, and its AdamW moments, lives on a rank as
  its block under the reference's rules, ``fit_spec(param_spec(name,
  shape), shape, grid)`` (FSDP over the batch axes on one dim, TP over
  ``model`` on the other; experts over ``data``), in the reference's
  per-dimension axis names.  The port's weights are not stacked on a
  group axis, so a scanned layer's spec is the reference's without its
  leading ``None``.  ``local_block`` cuts a rank's block out of a full
  tensor, ``gather_full`` and ``gather_to_root`` put the full tensor back
  together (for checks; a checkpoint is written by each rank's blocks).
* **Activations** follow the reference's kind table (``spec_for``): the
  batch over ``pod``/``data``, heads, FFN columns and the vocabulary
  over ``model``, experts over ``data``.
* **Collectives** go through ``repro_torch.core.runtime`` on the grid's
  lines (a ``ProcessGrid``'s per-axis sub-groups), in fixed orders, so a
  sharded step repeats bit for bit; ``gather_leaf`` and ``tp_copy``/
  ``tp_reduce`` are the differentiable forms the model uses.

``mesh_context(grid)`` activates a grid as the reference's does; outside
it ``active_mesh()`` is ``None`` and every model path runs as on one
device.  Nothing here imports ``jax``, starts a process group or touches
CUDA at import.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Optional

import torch

from repro_torch.core import runtime

Spec = tuple            # one entry a dim: None, an axis name, or a tuple

BATCH_AXES = ("pod", "data")
# the expert banks: experts over data (EP), not gathered by FSDP under
# the expert-parallel dispatch
EXPERT_LEAVES = ("we_gate", "we_up", "we_down")

_ctx = threading.local()


def _state():
    if not hasattr(_ctx, "mesh"):
        _ctx.mesh = None
        _ctx.batch_axes = None
        _ctx.fsdp_axes = None
    return _ctx


def _roles(names) -> tuple[Any, Any]:
    """The batch and FSDP axes of a grid's axis names, as the reference
    infers them: both ``(pod, data)`` with a pod axis, else ``data``."""
    batch = tuple(n for n in names if n in BATCH_AXES)
    batch_axes = batch if len(batch) > 1 else (batch[0] if batch else None)
    fsdp = batch if len(batch) > 1 else ("data" if "data" in names
                                         else None)
    return batch_axes, fsdp


@contextlib.contextmanager
def mesh_context(grid):
    """Activate ``grid`` (a ``runtime.ProcessGrid``, or for the spec rules
    alone any grid with ``axis_names`` and ``shape``).  Axis roles come
    from the axis names."""
    st = _state()
    prev = (st.mesh, st.batch_axes, st.fsdp_axes)
    st.mesh = grid
    st.batch_axes, st.fsdp_axes = _roles(grid.axis_names)
    try:
        yield grid
    finally:
        st.mesh, st.batch_axes, st.fsdp_axes = prev


def active_mesh():
    """The active grid, or ``None``."""
    return _state().mesh


# ---------------------------------------------------------------------------
# Activation layouts (logical kinds)
# ---------------------------------------------------------------------------

def spec_for(kind: str) -> Optional[Spec]:
    """The layout of a logical activation kind on the active grid (the
    reference's table), or ``None`` outside a grid or for an unknown
    kind."""
    st = _state()
    if st.mesh is None:
        return None
    b = st.batch_axes
    table = {
        "batch_seq": (b, None),                 # (B, T) tokens
        "act": (b, None, None),                 # (B, T, D)
        "act_sp": (b, "model", None),           # (B, T/TP, D) Megatron-SP
        "act_ffn": (b, None, "model"),          # (B, T, F)
        "act_heads": (b, "model", None, None),  # (B, H, T, hd)
        "logits": (b, None, "model"),           # (B, T, V)
        "kv_cache": (b, "model", None, None),   # (B, Hkv, L, hd)
        "kv_cache_seq": (b, None, "data", None),
        "moe_buf_d": ("data", None, None),      # (E, C, D) expert buffers
        "moe_buf_f": ("data", None, "model"),   # (E, C, F) expert hidden
        "tokens_flat": (b, None),               # (B·T, D)
        "particles": (b, None),                 # (N, state_dim)
    }
    return table.get(kind)


# ---------------------------------------------------------------------------
# Parameter rules (name pattern → spec)
# ---------------------------------------------------------------------------

def leaf_of(path: str) -> str:
    """The leaf name of a weight's path: the port's dotted names
    (``blocks.3.attn.wq``) or the reference's slashed ones."""
    return path.replace("/", ".").split(".")[-1]


def param_spec(path: str, shape: tuple[int, ...], mesh=None) -> Spec:
    """The spec of a weight by its leaf name and rank (the reference's
    ``param_spec``): the rules address the trailing dims and pad the
    leading ones with ``None``.  The FSDP axes come from ``mesh``'s axis
    names, else from the active grid."""
    if mesh is not None:
        ax = tuple(n for n in BATCH_AXES if n in mesh.axis_names)
        fsdp = ax if len(ax) > 1 else (ax[0] if ax else None)
    else:
        fsdp = _state().fsdp_axes

    def pad(tail: tuple) -> Spec:
        extra = len(shape) - len(tail)
        return tuple([None] * extra + list(tail))

    leaf = leaf_of(path)
    if leaf == "embed":
        return pad(("model", fsdp))              # (V, D)
    if leaf == "lm_head":
        return pad((fsdp, "model"))              # (D, V)
    if leaf == "img_proj":
        return pad((None, "model"))
    if leaf in ("we_gate", "we_up"):
        return pad(("data", None, "model"))      # (E, D, F)
    if leaf == "we_down":
        return pad(("data", "model", None))      # (E, F, D)
    if leaf == "router":
        return pad((fsdp, None))
    if leaf in ("w_gate", "w_up"):
        return pad((fsdp, "model"))              # (D, F) column
    if leaf == "w_down":
        return pad(("model", fsdp))              # (F, D) row
    if leaf in ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b", "w_gate_in",
                "w_x", "w_in"):
        return pad((fsdp, "model"))              # column-parallel
    if leaf in ("wo", "w_out"):
        return pad(("model", fsdp))              # row-parallel
    if leaf in ("wq_a", "wkv_a"):
        return pad((fsdp, None))                 # low-rank in-projection
    if leaf in ("w_rec_gate", "w_in_gate"):
        return pad((fsdp, "model"))
    return pad(tuple(None for _ in shape))       # norms, biases, scalars


def axes_of(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def fit_spec(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop the sharding of every dim its axes' extent does not divide,
    and the axes the grid lacks (the reference's ``fit_spec``: mamba2's
    vocabulary of 50280 over a 16-way ``model`` stays whole)."""
    out = []
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        axes = tuple(a for a in axes_of(entry) if a in mesh.shape)
        if not axes:
            out.append(None)
            continue
        extent = math.prod(mesh.shape[a] for a in axes)
        entry = axes if len(axes) > 1 else axes[0]
        out.append(entry if dim % extent == 0 else None)
    return tuple(out)


def _shapes(params) -> dict[str, tuple[int, ...]]:
    if isinstance(params, dict):
        return {n: tuple(getattr(x, "shape", x)) for n, x in params.items()}
    return {n: tuple(p.shape) for n, p in params.named_parameters()}


def make_param_shardings(mesh, params) -> dict[str, Spec]:
    """Every named weight's fitted spec: ``params`` is a full decoder or a
    dict of full tensors (``meta`` ones do) or shapes by name."""
    return {n: fit_spec(param_spec(n, s, mesh), s, mesh)
            for n, s in _shapes(params).items()}


# ---------------------------------------------------------------------------
# Blocks: cutting, gathering
# ---------------------------------------------------------------------------

def _coords(grid, coords=None) -> dict[str, int]:
    coords = grid.coords if coords is None else coords
    return dict(zip(grid.axis_names, coords))


def block_slices(spec: Spec, shape, grid, coords=None) -> tuple:
    """The slices of a full tensor of ``shape`` that form the block of the
    rank at ``coords`` (default this rank's): a dim over several axes is
    split row-major in the entry's order."""
    at = _coords(grid, coords)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = axes_of(entry)
        n = math.prod(grid.shape[a] for a in axes)
        i = 0
        for a in axes:
            i = i * grid.shape[a] + at[a]
        size = dim // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def local_block(x, spec: Spec, grid, coords=None):
    """This rank's (or the rank at ``coords``') block of the full ``x``
    (a tensor or a numpy array), in storage of its own: the full tensor
    can be freed."""
    blk = x[block_slices(spec, x.shape, grid, coords)]
    if isinstance(x, torch.Tensor):
        return blk.clone()
    return blk.copy()


def on_line(fn, x: torch.Tensor, line, *args) -> torch.Tensor:
    """A facade verb on a rank's value without a shard dim."""
    return fn(x.unsqueeze(0), line, *args).squeeze(0)


def _lines(grid, axes) -> list:
    """The lines of ``axes`` with more than one rank, innermost first
    (none on one device, ``grid`` ``None``)."""
    if grid is None:
        return []
    return [grid.axis(a) for a in reversed(axes) if grid.shape[a] > 1]


def gather_leaf(x: torch.Tensor, spec: Spec, grid, axes,
                fn=runtime.fsdp_gather) -> torch.Tensor:
    """``x`` (a block) gathered over ``axes`` on every dim they shard: a
    dim over several axes is gathered over its innermost axis first.  The
    default verb is the FSDP gather (its backward reduce-scatters).
    On one device (``grid`` ``None``) ``x`` is whole already."""
    if grid is None:
        return x
    for dim, entry in enumerate(spec):
        over = axes_of(entry)
        if not any(a in axes for a in over):
            continue
        if not all(a in axes for a in over):
            raise ValueError(f"dim {dim} is split over {over}; gathering "
                             f"over {axes} alone would not make it whole")
        for line in _lines(grid, over):
            x = on_line(fn, x, line, dim + 1)
    return x


@torch.no_grad()
def gather_full(x: torch.Tensor, spec: Spec, grid) -> torch.Tensor:
    """The full tensor of a block, on every rank (for checks and
    serving's logits); ``x`` itself on one device."""
    if grid is None:
        return x
    return gather_leaf(x, spec, grid, tuple(grid.axis_names),
                       runtime.all_gather_tiled)


def _gather_to_first(x: torch.Tensor, line, dim: int, device):
    """The line's blocks concatenated along ``dim`` on its shard 0, on
    ``device`` (point-to-point messages to shard 0; a CUDA block staged
    through host memory on gloo), ``None`` on the others."""
    wire = runtime._wire(x.detach(), line)
    if line.rank:
        runtime._exchange({0: wire}, {}, line)
        return None
    parts = [wire] + [torch.empty_like(wire) for _ in range(1, line.shards)]
    runtime._exchange({}, {q: parts[q] for q in range(1, line.shards)},
                      line)
    full = torch.cat(parts, dim)
    if full.device != torch.device(device):
        line.staged.bytes += full.numel() * full.element_size()
    return full.to(device)


@torch.no_grad()
def gather_to_root(x: torch.Tensor, spec: Spec, grid, device=None):
    """The full tensor of a block on the grid's rank 0, on ``device``
    (default the block's), and ``None`` on the others (for a check rank 0
    makes): each line gathers to its first rank only, innermost axis
    first, so a whole tensor crosses to rank 0 once."""
    device = x.device if device is None else torch.device(device)
    for dim, entry in enumerate(spec):
        for line in _lines(grid, axes_of(entry)):
            if x is None:
                break
            x = _gather_to_first(x, line, dim, device)
    if x is None or grid.rank:
        return None
    return x.to(device)


def grid_digest(tensors: dict, specs: dict, grid) -> dict:
    """Each tensor's digest as if it were whole: the sum and the wrapped
    sum of squares of its int32 words, summed exactly (int64) over the
    blocks of the axes that shard it, so any grid (or one device) that
    holds the same full tensor gives the same digest."""
    out = {}
    for name, t in tensors.items():
        b = t.detach().contiguous().view(torch.int32).to(torch.int64)
        part = torch.stack([b.sum(), (b * b).sum()])
        axes = tuple(a for a in grid.axis_names
                     if any(a in axes_of(e) for e in specs[name]))
        out[name] = tuple(int(v) for v in psum_over(part, grid, axes))
    return out


def psum_over(x: torch.Tensor, grid, axes) -> torch.Tensor:
    """``x`` summed over the lines of ``axes`` (innermost first, each in
    the facade's fixed order); not differentiable."""
    for line in _lines(grid, axes):
        x = on_line(runtime.psum, x, line)
    return x


def pmax_over(x: torch.Tensor, grid, axes) -> torch.Tensor:
    """``x``'s max over the lines of ``axes``."""
    for line in _lines(grid, axes):
        x = on_line(runtime.pmax, x, line)
    return x


def batch_axes(grid) -> tuple[str, ...]:
    """The grid's batch axes (``pod``, ``data``) in grid order (none on
    one device, ``grid`` ``None``)."""
    if grid is None:
        return ()
    return tuple(a for a in grid.axis_names if a in BATCH_AXES)


def batch_shards(grid) -> int:
    """The number of batch shards (the product of the batch axes)."""
    return math.prod(grid.shape[a] for a in batch_axes(grid))


def batch_index(grid, coords=None) -> int:
    """This rank's batch shard: its batch coordinates, row-major."""
    at = _coords(grid, coords)
    i = 0
    for a in batch_axes(grid):
        i = i * grid.shape[a] + at[a]
    return i


def model_size(grid) -> int:
    """The ``model`` axis's size (1 without one, or on one device)."""
    return 1 if grid is None else grid.shape.get("model", 1)


def model_line(grid):
    """The rank's ``model`` line, or ``None`` where the axis is absent or
    of size 1 (no tensor parallelism)."""
    return grid.axis("model") if model_size(grid) > 1 else None


def model_index(grid) -> int:
    """This rank's ``model`` coordinate (0 without the axis)."""
    return 0 if grid is None else _coords(grid).get("model", 0)


def tp_copy(x: torch.Tensor, grid) -> torch.Tensor:
    """Megatron's ``f`` over ``model`` (identity without TP)."""
    line = model_line(grid)
    return x if line is None else on_line(runtime.tp_copy, x, line)


def tp_reduce(x: torch.Tensor, grid) -> torch.Tensor:
    """Megatron's ``g`` over ``model`` (identity without TP)."""
    line = model_line(grid)
    return x if line is None else on_line(runtime.tp_reduce, x, line)


def batch_slice(x: torch.Tensor, grid, microbatches: int = 1
                ) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` (rows first): with
    ``microbatches`` m, row block ``j`` of the m is the reference's
    microbatch ``j`` and the rank keeps its share of each, so its j-th
    local block is its share of microbatch ``j``."""
    n, m = batch_shards(grid), microbatches
    if x.shape[0] % (n * m):
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over {m} microbatches × {n} batch shards")
    per = x.shape[0] // (n * m)
    i = batch_index(grid)
    parts = x.reshape((m, n, per) + tuple(x.shape[1:]))[:, i]
    return parts.reshape((m * per,) + tuple(x.shape[1:])).contiguous()


# ---------------------------------------------------------------------------
# A decoder's blocks on a rank
# ---------------------------------------------------------------------------

class RankBlocks:
    """Cuts each full weight, as it is made, down to the block of the rank
    at ``coords`` (default this rank's) and records its spec and full
    shape: the ``keep`` of ``model.init_params`` and ``convert``, which
    build a rank's decoder a layer at a time."""

    def __init__(self, grid, coords=None):
        self.grid, self.coords = grid, coords
        self.specs: dict[str, Spec] = {}
        self.shapes: dict[str, tuple[int, ...]] = {}

    def __call__(self, name: str, x):
        shape = tuple(x.shape)
        spec = fit_spec(param_spec(name, shape, self.grid), shape, self.grid)
        self.specs[name], self.shapes[name] = spec, shape
        return local_block(x, spec, self.grid, self.coords)

    def attach(self, model):
        """Mark ``model`` (built from the blocks) as sharded on the grid."""
        model.shard_specs = dict(self.specs)
        model.full_shapes = dict(self.shapes)
        model.grid_shape = dict(self.grid.shape)
        return model


def check_model_grid(model, grid) -> None:
    """Raise unless ``model`` holds its blocks for ``grid``."""
    got = getattr(model, "grid_shape", None)
    if got != dict(grid.shape):
        raise ValueError(f"the decoder's blocks are for grid {got}, the "
                         f"active grid is {dict(grid.shape)}")


def _unsupported(cfg, grid) -> str | None:
    """Why ``cfg`` cannot run on ``grid`` yet, or ``None``."""
    from repro_torch.models.lm import model as M
    m = model_size(grid)
    if m == 1:
        return None
    kinds = {k for k, _ in M.make_plan(cfg).layers()}
    if "M" in kinds and cfg.n_heads % m:
        return (f"{cfg.name}: {cfg.n_heads} latent-attention heads over a "
                f"model axis of {m}")
    if "D" in kinds:
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        per, hpg = heads // m, heads // s.n_groups
        if heads % m or (per % hpg and hpg % per):
            return (f"{cfg.name}: {heads} SSD heads in {s.n_groups} groups "
                    f"over a model axis of {m}")
    full = M.init_params(cfg, 0, device="meta", dtype=torch.float32)
    for name, shape in _shapes(full).items():
        want = param_spec(name, shape, grid)
        got = fit_spec(want, shape, grid)
        lost = [i for i, (w, g) in enumerate(zip(want, got))
                if "model" in axes_of(w) and "model" not in axes_of(g)]
        if lost:
            return (f"{cfg.name}: {name} {shape} does not split over a "
                    f"model axis of {m}; replicating it")
    return None


_SUPPORTED: dict = {}


def check_supported(cfg, grid) -> None:
    """Raise ``ValueError`` before any work for what the grid cannot run
    yet (ROADMAP A13 part b item c): a weight whose ``model`` split
    ``fit_spec`` would drop (it would run replicated under
    tensor-parallel collectives: mamba2's vocabulary of 50280 over a
    ``model`` axis of 16), latent-attention heads or SSD heads that
    ``model`` does not divide.  Every kind runs over ``model``, and so do
    query and key/value heads that it does not divide (the rank's whole
    heads, ``head_range``).  The answer is kept by config and grid
    shape."""
    key = (cfg, tuple(sorted(grid.shape.items())))
    if key not in _SUPPORTED:
        _SUPPORTED[key] = _unsupported(cfg, grid)
    why = _SUPPORTED[key]
    if why is not None:
        raise ValueError(f"{why} waits for ROADMAP A13 part b item c")


# ---------------------------------------------------------------------------
# The kinds over model: whole heads, re-cut weights, cache length shards
# ---------------------------------------------------------------------------

def head_range(n: int, grid) -> tuple[int, int]:
    """The rank's whole heads of ``n`` over ``model``: ``⌊n·r/m⌋ …
    ⌊n·(r+1)/m⌋ - 1`` (every head on one device); where ``m`` divides
    ``n`` exactly the heads of the rank's column block."""
    m, r = model_size(grid), model_index(grid)
    return n * r // m, n * (r + 1) // m


def model_gather(x: torch.Tensor, grid, dim: int,
                 full: int | None = None) -> torch.Tensor:
    """``x``'s blocks along ``dim`` gathered over ``model`` (a weight's
    column or row block whole, an activation's channels all); the
    backward reduce-scatters, so each rank's block gets the sum of every
    rank's partial gradient (each rank used its own part).  ``x`` itself
    without a ``model`` axis, or when it is ``full`` long already."""
    line = model_line(grid)
    if line is None or x.shape[dim] == full:
        return x
    return on_line(runtime.fsdp_gather, x, line, dim % x.dim() + 1)


def model_all(x: torch.Tensor, grid, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order over
    ``model`` (not differentiable: the decode's partials and queries)."""
    line = model_line(grid)
    if line is None:
        return x
    return on_line(runtime.all_gather_tiled, x, line, dim % x.dim() + 1)


def length_slots(max_len: int, grid) -> int:
    """The slots of a rank's cache length shard over ``model``:
    ``ceil(max_len / m)``, the rank at ``model`` coordinate r holding
    positions from ``r·slots`` on.  Where ``m`` divides ``max_len`` it is
    the reference's block; where it does not, the reference replicates
    the cache and a rank holds less."""
    return -(-max_len // model_size(grid))


def tp_sum(x: torch.Tensor, grid) -> torch.Tensor:
    """The sum over ``model`` of per-rank partials whose result every rank
    uses on its own part (``tp_copy`` of ``tp_reduce``: the forward sums
    in the facade's fixed order, the backward sums the ranks' partial
    gradients): a norm's sum of squares over channels split by rank."""
    return tp_copy(tp_reduce(x, grid), grid)


def moe_expert_parallel(cfg, grid) -> bool:
    """Whether a MoE FFN runs ``moe.apply_moe_ep`` on ``grid``: the
    config asks for ``ep_shardmap`` and the grid has a ``data`` axis whose
    size divides the experts (the reference's fallbacks otherwise)."""
    return (grid is not None and cfg.moe is not None and cfg.moe.dispatch == "ep_shardmap"
            and "data" in grid.shape
            and cfg.moe.n_experts % grid.shape["data"] == 0)


def gather_axes_of(name: str, spec: Spec, grid, expert_parallel: bool
                   ) -> tuple[str, ...]:
    """The axes a leaf is gathered over on use: the batch axes that shard
    it, except an expert bank's ``data`` under the expert-parallel
    dispatch (each rank computes its own experts)."""
    if expert_parallel and leaf_of(name) in EXPERT_LEAVES:
        return ()
    return tuple(a for a in batch_axes(grid)
                 if any(a in axes_of(e) for e in spec))


def reduce_replicated_grads(params, grid) -> None:
    """Sum over the batch axes the gradient of every weight that no batch
    axis shards (norms, scalars, a dim ``fit_spec`` left whole): its
    ranks saw different tokens, and no reduce-scatter summed them.  A
    weight sharded over a batch axis got its sum from the backward of its
    gather (FSDP) or of the expert all-to-all (EP)."""
    axes = batch_axes(grid)
    for name, p in params.named_parameters():
        spec = params.shard_specs[name]
        if p.grad is None or any(a in axes_of(e) for e in spec
                                 for a in axes):
            continue
        p.grad = psum_over(p.grad, grid, axes)


def sharded_sq_norm(grads: dict, specs: dict, grid) -> torch.Tensor:
    """``sum(x²)`` over every leaf's whole tensor, in float32: each local
    block's squares summed, the leaves grouped by the axes that shard
    them and each group summed over its axes, so a replicated leaf counts
    once and not once a rank."""
    groups: dict[tuple, torch.Tensor] = {}
    for name, g in grads.items():
        axes = tuple(a for a in grid.axis_names
                     if any(a in axes_of(e) for e in specs[name]))
        sq = torch.sum(torch.square(g.float()))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = None
    for axes in sorted(groups):
        part = psum_over(groups[axes], grid, axes)
        total = part if total is None else total + part
    return total
