"""Checkpointing: atomic, manifest-driven, keep-k, elastic restore (the
port's ``repro/checkpoint/store.py``, in the same on-disk format).

Layout:  <dir>/step_<n>/
           manifest.json   tree structure, shapes, dtypes, step, meta
           <leaf-id>.npy   one array per tree leaf, as raw bytes

Writes go to ``step_<n>.tmp`` and are published with an atomic
``os.replace`` -- a crashed writer never corrupts the newest checkpoint.
Leaves are visited in the JAX package's order (``repro_torch.tree``) and
named as its ``_leaf_paths`` names them, so leaf *i* of a checkpoint
written by either package is leaf *i* for the other: each restores the
other's checkpoints. bfloat16 leaves are stored as their raw bytes with
the dtype written ``"bfloat16"`` (numpy has no bfloat16). Restore casts
each leaf to the dtype of the receiving tree's leaf and places it on
``device`` (by default where that leaf lies).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..tree import describe, flatten_with_path, leaves, path_str, unflatten


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    return [(path_str(path, "_") or "leaf", leaf)
            for path, leaf in flatten_with_path(tree)]


def _raw(leaf) -> tuple[np.ndarray, str, list]:
    """(raw bytes as uint8, dtype name, shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.uint8).cpu().numpy()
            return raw, "bfloat16", list(t.shape)
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return np.frombuffer(arr.tobytes(), np.uint8), str(arr.dtype), \
        list(arr.shape)


def save_checkpoint(directory: str | Path, step: int, tree: Any, *,
                    meta: Optional[dict] = None, keep: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    names = []
    for i, (name, leaf) in enumerate(_leaf_paths(tree)):
        lid = f"{i:05d}_{name[:120]}"
        raw, dtype, shape = _raw(leaf)
        np.save(tmp / f"{lid}.npy", raw, allow_pickle=False)
        names.append({"id": lid, "dtype": dtype, "shape": shape})
    manifest = {
        "step": step,
        "time": time.time(),
        "treedef": describe(tree),
        "leaves": names,
        "meta": meta or {},
        "format": 2,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    # keep-k retention
    ckpts = sorted(directory.glob("step_*"))
    ckpts = [c for c in ckpts if c.is_dir() and not c.name.endswith(".tmp")]
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(d for d in directory.glob("step_*")
                   if d.is_dir() and (d / "manifest.json").exists())
    return ckpts[-1] if ckpts else None


def _load_leaf(path: Path, lm: dict) -> torch.Tensor:
    raw = torch.from_numpy(np.load(path / f"{lm['id']}.npy"))
    if lm["dtype"] == "bfloat16":
        t = raw.view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.numpy().view(np.dtype(lm["dtype"])))
    return t.reshape(lm["shape"])


def restore_checkpoint(path: str | Path, tree_like: Any, *,
                       device=None) -> tuple[int, Any, dict]:
    """Restore into the structure of ``tree_like``: each leaf cast to the
    dtype of ``tree_like``'s tensor leaf and put on ``device``, or, when
    that is None, on the device of that leaf (where ``tree_like``'s leaf is
    no tensor: the stored dtype, on the card)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    arrays = [_load_leaf(path, lm) for lm in manifest["leaves"]]
    ref = leaves(tree_like)
    if len(ref) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, structure wants "
            f"{len(ref)}")
    out = []
    for a, r in zip(arrays, ref):
        if isinstance(r, torch.Tensor):
            dtype, dev = r.dtype, (r.device if device is None else
                                   resolve_device(device))
        else:
            dtype, dev = a.dtype, resolve_device(device)
        out.append(a.to(device=dev, dtype=dtype))
    return manifest["step"], unflatten(tree_like, out), \
        manifest.get("meta", {})

