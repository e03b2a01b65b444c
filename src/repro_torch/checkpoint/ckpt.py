"""Checkpointing with atomic commit, auto-resume and elastic restore, the
counterpart of `repro.checkpoint.ckpt`, writing its layout byte for byte.

Layout:
  <dir>/step_<n>.tmp-<pid>/   — write in progress
  <dir>/step_<n>/manifest.json, arr_<i>.npy …  — committed (atomic rename)

The tree is a nested dict (a train state through
`training.train_loop.state_tree`); its leaves are numbered in
`jax.tree_util` order (dict keys sorted at every level) and named by
`keystr` ("['opt']['m']['layers']['attn']['wq']"), so `arr_{i:05d}.npy`
holds the same leaf in both packages.  A bfloat16 leaf is written from
its int16 bits under the npy header `'descr': '<V2'` (what `np.save` of
an ml_dtypes bfloat16 array writes), and restored through the
manifest's dtype; no ml_dtypes is needed either way.

Fault-tolerance contract:
  * A crash mid-save leaves only a .tmp dir — never a corrupt manifest;
    restore ignores tmp dirs, cleanup removes them.
  * `restore_checkpoint(..., mesh, pspecs)` places each leaf by its spec
    over the restoring mesh (`sharding.rules.shard`): restoring onto
    another topology is the same code path as a same-size restart.
  * The manifest records the writing mesh shape for audit.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..device import resolve_device
from ..sharding.rules import shard

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "cleanup_old"]

_MANIFEST = "manifest.json"
_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
             torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _paths_of(tree, prefix: str = ""):
    """(keystr, leaf) in jax.tree_util order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths_of(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _host(leaf) -> tuple[np.ndarray, str]:
    """(C-ordered host array, dtype name); a bfloat16 leaf as its int16
    bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), _NP_NAMES[t.dtype]
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def _save_array(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def save_checkpoint(ckpt_dir: str, step: int, tree, *, mesh=None,
                    extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, (name, leaf) in enumerate(_paths_of(tree)):
        arr, dtype = _host(leaf)
        fn = f"arr_{i:05d}.npy"
        _save_array(os.path.join(tmp, fn), arr, dtype)
        entries.append({"key": name, "file": fn, "shape": list(arr.shape),
                        "dtype": dtype})
    manifest = {
        "step": step,
        "entries": entries,
        "mesh_shape": (dict(mesh.shape) if mesh is not None else None),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):          # overwrite-safe
        shutil.rmtree(final)
    os.rename(tmp, final)              # atomic commit
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and ".tmp" not in d and \
           os.path.exists(os.path.join(ckpt_dir, d, _MANIFEST)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_like(template, leaves):
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def restore_checkpoint(ckpt_dir: str, template, step: int | None = None, *,
                       mesh=None, pspecs=None, device=None):
    """Restore into the structure of `template` (a nested dict whose
    leaves have the shapes wanted: tensors, `meta` tensors, arrays).
    Leaves come back as tensors on `device` (None: the card; "cpu" on
    the host); with (mesh, pspecs) a leaf that has a spec comes back
    placed over the mesh instead, as `sharding.rules.shard`'s list of
    one block a logical device.  Returns (tree, manifest)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["entries"]}
    specs = dict(_paths_of(pspecs)) if pspecs is not None else {}
    leaves = []
    for key, tmpl in _paths_of(template):
        e = by_key[key]
        t = _load(os.path.join(path, e["file"]), e["dtype"])
        want = tuple(getattr(tmpl, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: ckpt {tuple(t.shape)} != want {want}")
        spec = specs.get(key)
        if mesh is not None and spec is not None:
            leaves.append(shard(t, mesh, spec))
        else:
            leaves.append(t.to(dev))
    return _unflatten_like(template, iter(leaves)), manifest


def cleanup_old(ckpt_dir: str, keep: int = 3):
    """Drop all but the newest `keep` checkpoints + stale tmp dirs."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        (d for d in os.listdir(ckpt_dir)
         if d.startswith("step_") and ".tmp" not in d))
    for d in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    for d in os.listdir(ckpt_dir):
        if ".tmp" in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
