"""Sharded, atomic, elastic checkpointing (port of ``repro.train.checkpoint``).

Layout:  <dir>/step_<N:08d>/
            manifest.json       (step, leaf names, shard count, meta)
            shard_<p>.npz       (leaves p, p + num_shards, ... as leaf_<i>)

* leaves are named by their path in the tree: ``params.layers.3.mixer.wq``,
  ``opt.m.layers.3.mixer.wq``, ``opt.step`` (dict keys, list indices and a
  ``ParamTree``'s parameter names, joined by dots).
* atomic: written to step_<N>.tmp then os.replace()'d.
* elastic: restore merges whatever shard files the manifest lists, by
  name, into the tensors of the tree it is given, on their devices:
  shard counts may differ between save and load.
* the data pipeline needs no state file at all: batches are a pure
  function of (seed, step), so restart only needs ``step`` from the
  manifest.
* async: ``save(..., background=True)`` copies every leaf to host memory
  synchronously, then writes in a thread (the train step, which updates
  the tensors in place, continues).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of nested dicts, lists and
    ``ParamTree``s, depth first in their own order."""
    if isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    elif hasattr(tree, "items"):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a {type(tree).__name__}, "
                        "not a tensor")


def save(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    meta: Optional[Dict] = None,
    num_shards: int = 1,
    background: bool = False,
    keep: int = 3,
) -> threading.Thread | None:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>``; with ``background``,
    return the writing thread (join it before the next save)."""
    names, leaves = zip(*named_leaves(tree))
    arrays = [t.detach().to("cpu", copy=True).numpy() for t in leaves]
    manifest = {
        "step": int(step),
        "num_leaves": len(arrays),
        "num_shards": int(num_shards),
        "names": list(names),
        "meta": meta or {},
    }

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for p in range(num_shards):
            arrs = {f"leaf_{i}": arrays[i] for i in range(p, len(arrays), num_shards)}
            np.savez(os.path.join(tmp, f"shard_{p}.npz"), **arrs)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Copy checkpoint ``step`` (the latest if None) into the tensors of
    ``tree_like`` in place, on their devices and dtypes, and return
    ``(tree_like, manifest)``.  Works across shard counts: the shards are
    merged by leaf name.  Raises if a leaf's name or shape differs."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    targets = dict(named_leaves(tree_like))
    if set(targets) != set(manifest["names"]):
        diff = sorted(set(targets) ^ set(manifest["names"]))
        raise ValueError(f"checkpoint {d} and the tree differ in leaves {diff[:8]}")
    seen = set()
    with torch.no_grad():
        for p in range(manifest["num_shards"]):
            with np.load(os.path.join(d, f"shard_{p}.npz")) as z:
                for k in z.files:
                    name = manifest["names"][int(k.split("_")[1])]
                    arr, dst = z[k], targets[name]
                    if tuple(arr.shape) != tuple(dst.shape):
                        raise ValueError(f"{name}: checkpoint shape {arr.shape}, tree "
                                         f"{tuple(dst.shape)}")
                    dst.copy_(torch.from_numpy(arr))
                    seen.add(name)
    if len(seen) != len(targets):
        raise ValueError(f"checkpoint {d} lacks leaves {sorted(set(targets) - seen)[:8]}")
    return tree_like, manifest
