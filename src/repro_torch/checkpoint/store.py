"""Atomic checkpoints of array trees (port of ``repro.checkpoint.store``).

* **Atomic**: a checkpoint is written to ``step_XXXXXXXX.tmp/`` and
  renamed to ``step_XXXXXXXX/`` only after every leaf and the manifest are
  fsync'd, so ``latest_step`` never picks up a half-written one.
* **Bounded disk**: only the ``keep`` newest checkpoints stay.
* **The reference's layout**: one ``.npy`` a leaf, named by its tree path
  (dict keys and sequence indices joined by ``__``, dict keys in sorted
  order, as ``jax.tree_util`` flattens them), plus ``manifest.json``.  A
  tree of numpy arrays written by either package loads in the other.

Leaves may be numpy arrays or torch tensors (saved from the host).
``save_blocks`` writes the same layout from the ranks of a process
group, each rank its blocks of every full tensor into the memory-mapped
files (no tensor crosses between ranks); ``load_checkpoint`` can hand
each leaf, memory-mapped, to a ``cut`` that keeps a block of it (a rank
restoring its blocks never holds a whole tree).  A
bfloat16 tensor, which numpy cannot hold, is stored as its uint16 bits
with ``"bfloat16"`` in the manifest and comes back as bfloat16.
``load_checkpoint`` returns torch tensors on the ``device`` it is given.
``save_json``/``load_json`` persist control-plane documents (the fleet
registry, stream placements) with the same write-fsync-rename rule.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in the reference's order: dict keys sorted,
    sequences in order; any other object is a leaf."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree) for pair in
                _flatten(x, path + (i,))]
    return [(path, tree)]


def _unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` whose leaves come from the iterator
    ``leaves`` in ``_flatten``'s order."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def leaf_name(path: tuple) -> str:
    """A leaf's file stem: its path's keys and indices joined by ``__``."""
    return "__".join(str(k) for k in path)


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array and the dtype the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    """Write ``tree`` atomically as checkpoint ``step``; keep the newest
    ``keep``.  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for path, leaf in _flatten(tree):
        name = leaf_name(path)
        arr, dtype = _host_array(leaf)
        with open(os.path.join(tmp, name + ".npy"), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"name": name, "shape": list(arr.shape),
                                   "dtype": dtype})
    manifest["treedef"] = "repro_torch: " + ", ".join(
        leaf["name"] for leaf in manifest["leaves"])
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)      # atomicity boundary
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_blocks(directory: str, step: int, leaves: list, *, rank: int,
                barrier, keep: int = 3) -> Optional[str]:
    """Write checkpoint ``step`` from every rank of a process group, in
    ``save_checkpoint``'s layout (one full ``.npy`` a leaf): ``leaves`` is
    ``[(path, full_shape, dtype, blocks)]`` in ``_flatten``'s order, the
    same on every rank, ``blocks`` this rank's ``[(slices, tensor)]`` to
    write (empty where another rank writes that block).  Rank 0 makes the
    files, every rank writes and fsyncs its blocks between ``barrier()``
    calls, and rank 0 writes the manifest and renames the directory into
    place (returning its path; the other ranks ``None``)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"

    def file_of(path):
        return os.path.join(tmp, leaf_name(path) + ".npy")

    def np_dtype(dtype: torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.uint16), "bfloat16"
        name = str(torch.empty((), dtype=dtype).numpy().dtype)
        return np.dtype(name), name

    if rank == 0:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for path, shape, dtype, _ in leaves:
            np.lib.format.open_memmap(file_of(path), mode="w+",
                                      dtype=np_dtype(dtype)[0],
                                      shape=tuple(shape))
    barrier()
    for path, shape, dtype, blocks in leaves:
        if not blocks:
            continue
        out = np.lib.format.open_memmap(file_of(path), mode="r+")
        for slices, block in blocks:
            arr, _ = _host_array(block)
            out[slices] = arr
        out.flush()
        del out
        _fsync_file(file_of(path))
    barrier()
    if rank:
        barrier()
        return None
    manifest = {"step": step, "leaves": [
        {"name": leaf_name(path), "shape": list(shape),
         "dtype": np_dtype(dtype)[1]} for path, shape, dtype, _ in leaves]}
    manifest["treedef"] = "repro_torch: " + ", ".join(
        leaf["name"] for leaf in manifest["leaves"])
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)      # atomicity boundary
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    barrier()
    return final


def all_steps(directory: str) -> list[int]:
    """Every complete checkpoint's step, ascending (``.tmp`` excluded)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def save_json(directory: str, name: str, obj: Any) -> str:
    """Atomically persist a JSON document as ``<name>.json`` (write
    ``.tmp``, fsync, rename).  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, name + ".json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)     # atomicity boundary
    return final


def load_json(directory: str, name: str) -> Any:
    """A document written by ``save_json`` (``FileNotFoundError`` when it
    was never written)."""
    with open(os.path.join(directory, name + ".json")) as f:
        return json.load(f)


def leaf_paths(tree: Any) -> list[tuple]:
    """The tree paths of ``tree``'s leaves in the order a checkpoint
    writes them."""
    return [path for path, _ in _flatten(tree)]


def load_checkpoint(directory: str, step: int, like: Any,
                    device, cut=None) -> Any:
    """Checkpoint ``step`` as a tree with the structure of ``like`` (its
    leaves' values are not read; shapes come from disk), every leaf a
    torch tensor on ``device``.  With ``cut``, each leaf is read
    memory-mapped and ``cut(path, array)`` (a copy of a block of it) is
    what is loaded."""
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"]
                  for leaf in json.load(f)["leaves"]}
    device = torch.device(device)

    def read(path):
        name = leaf_name(path)
        arr = np.load(os.path.join(src, name + ".npy"),
                      mmap_mode=None if cut is None else "r")
        if cut is not None:
            arr = np.array(cut(path, arr), order="C")
        t = torch.from_numpy(arr)
        if dtypes.get(name) == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)

    return _unflatten(like, iter([read(p) for p, _ in _flatten(like)]))
