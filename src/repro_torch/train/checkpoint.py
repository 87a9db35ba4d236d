"""Step-atomic, CRC-checked checkpoints of a tensor tree (counterpart of
``repro/train/checkpoint.py``, in its on-disk format leaf for leaf, so a
checkpoint written by either package restores in the other).

* **Layout:** ``step_XXXXXXXX/`` holds ``manifest_p0.json`` (``step``,
  ``format`` 1, per leaf its file, shape, dtype name and CRC32) and one
  ``p0_<crc32(key):08x>.npy`` a leaf. Keys are the leaves' paths
  (``params/convs/0/w``, ``opt/step``; ``train/tree.py``); a ``None``
  leaf is ``{"none": true}``. The port writes as process 0 of one.
* **Step-atomic:** the leaves and the manifest go into
  ``step_XXXXXXXX.tmp``, each fsynced, and ``os.replace`` commits the
  directory; a crashed writer leaves only ``.tmp`` litter, which the next
  writer removes. A re-save of a committed step first retires the old
  copy to ``.retired``; a crash between the two renames is rolled back by
  the next ``save`` or ``latest_step``, so a step is never torn or lost.
* **Integrity:** restore checks every leaf's CRC32
  (``core/crc.py``) before any tensor is built, and raises
  ``CorruptCheckpoint``.
* **Retention:** the ``keep`` newest steps survive; older ones are
  removed after a commit, never before.
* **bfloat16:** a bfloat16 leaf is stored as raw 2-byte void records
  with "bfloat16" in the manifest (what ``np.save`` writes for the
  reference's ``ml_dtypes`` arrays) and read back through an int16 view,
  with no ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.crc import crc32_array
from repro_torch.train.tree import leaves_with_path, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d{8})$")
_RETIRED_SUFFIX = ".retired"
_PIDX = 0


class CorruptCheckpoint(RuntimeError):
    pass


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
    elif leaf.dtype == torch.bfloat16:
        bits = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        return bits.view("V2"), "bfloat16"
    else:
        arr = leaf.detach().cpu().numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, name: str, device) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    _recover_retired(ckpt_dir)
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(f))]
    return max(steps) if steps else None


def _gc_tmp(ckpt_dir: str) -> None:
    for f in os.listdir(ckpt_dir):
        if f.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, f), ignore_errors=True)


def _recover_retired(ckpt_dir: str) -> None:
    """Resolve interrupted same-step re-saves: a ``.retired`` copy whose
    replacement was committed is deleted; one whose replacement never
    landed is renamed back. ``.retired`` matches neither the ``.tmp``
    sweep nor a committed step, so only this resolves it."""
    for f in os.listdir(ckpt_dir):
        if not f.endswith(_RETIRED_SUFFIX):
            continue
        retired = os.path.join(ckpt_dir, f)
        final = os.path.join(ckpt_dir, f[:-len(_RETIRED_SUFFIX)])
        if os.path.isdir(final):
            shutil.rmtree(retired, ignore_errors=True)   # commit landed
        else:
            try:
                os.replace(retired, final)               # roll back
            except OSError:
                # a concurrent process rolled it back first: fine as long
                # as the step is committed
                if not os.path.isdir(final):
                    raise


def _fsynced(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write one step-atomic checkpoint of ``tree``; returns the committed
    directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _gc_tmp(ckpt_dir)
    _recover_retired(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    manifest: dict[str, Any] = {"step": step, "format": 1, "leaves": {}}
    for key, leaf in leaves_with_path(tree):
        if leaf is None:
            manifest["leaves"][key] = {"none": True}
            continue
        arr, name = _to_numpy(leaf)
        fname = f"p{_PIDX}_{zlib.crc32(key.encode()):08x}.npy"
        _fsynced(os.path.join(tmp, fname), lambda f, a=arr: np.save(f, a))
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": name, "crc": crc32_array(arr)}
    blob = json.dumps(manifest, indent=1).encode()
    _fsynced(os.path.join(tmp, f"manifest_p{_PIDX}.json"),
             lambda f: f.write(blob))
    # os.replace cannot replace a non-empty directory: a re-save of a
    # committed step retires the old copy first (see _recover_retired)
    if os.path.isdir(final):
        retired = final + _RETIRED_SUFFIX
        shutil.rmtree(retired, ignore_errors=True)
        os.replace(final, retired)
        while True:
            try:
                os.replace(tmp, final)
                break
            except OSError:
                # a concurrent reader rolled the retired copy back between
                # the two renames: retire it again and retry
                if not os.path.isdir(final):
                    raise
                shutil.rmtree(retired, ignore_errors=True)
                os.replace(final, retired)
        shutil.rmtree(retired, ignore_errors=True)
    else:
        os.replace(tmp, final)

    steps = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(f)))
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:08d}"),
                      ignore_errors=True)
    return final


def restore(ckpt_dir: str, target_tree, *, step: int | None = None,
            device=None):
    """Restore into the structure of ``target_tree`` (its leaves give the
    structure only). Tensors land on ``device``, or, when None, on the
    device of the target's leaf (the CPU where it is no tensor). Returns
    (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    cdir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(cdir, f"manifest_p{_PIDX}.json")) as f:
        manifest = json.load(f)

    loaded = []
    for key, leaf in leaves_with_path(target_tree):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise CorruptCheckpoint(f"leaf {key!r} missing from step {step}")
        if meta.get("none"):
            loaded.append(None)
            continue
        arr = np.load(os.path.join(cdir, meta["file"]))
        if crc32_array(arr) != meta["crc"]:
            raise CorruptCheckpoint(f"CRC mismatch for {key!r} @ step {step}")
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        loaded.append(_to_tensor(arr, meta["dtype"], dev))
    return tree_unflatten(target_tree, loaded), step
