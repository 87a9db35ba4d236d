"""The packed-BCNN deployment artifact (counterpart of
``repro/core/bcnn_artifact.py``): writer, reader and the tuning section.

An artifact is one directory: ``manifest.json`` (format name, version,
per-leaf shape / dtype / CRC32 for arrays, the static leaves k / fh / fw /
fc3_k / BN eps by value, the name of the live weights file, provenance and
an optional ``tuning`` section) and that ``weights-*.npz``.

* ``save_packed`` writes one with the reference's commit protocol: a
  fresh weights file first, then the atomic rename of the manifest as the
  single commit point; the reference's ``load_packed`` reads it leaf for
  leaf.
* ``load_packed`` checks the format, accepts versions
  ``MIN_VERSION..VERSION``, verifies every array's CRC32 before anything
  is built, and returns the port's ``BCNNPacked`` on the CPU; any mismatch
  raises ``ArtifactError``. ``packed_from_numpy`` builds the net from
  leaves keyed as ``walk`` keys them.
* ``load_tuning`` returns the tuned plan's payload ``{"key", "plan"}``
  (``kernels/autotune.py::plan_for_host`` decides whether it applies).
"""
from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core import bconv, blinear
from repro_torch.core.bcnn import BCNNPacked
from repro_torch.core.crc import crc32_array
from repro_torch.core.normbinarize import BNParams, NBThreshold

FORMAT = "bcnn-packed"
VERSION = 2                      # 2: optional "tuning" section
MIN_VERSION = 1
TUNING_VERSION = 1               # schema of the "tuning" section itself
MANIFEST = "manifest.json"
WEIGHTS_PREFIX = "weights-"      # one uniquely named npz per save


class ArtifactError(RuntimeError):
    """Unreadable / corrupt / incompatible deployment artifact."""


def load_manifest(path: str) -> dict:
    """Read and format/version-check the manifest at ``path``."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise ArtifactError(f"no {MANIFEST} under {path!r} — not an "
                            f"artifact directory (or an aborted save)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise ArtifactError(f"unparseable manifest at {path!r}: {e}") from e
    if manifest.get("format") != FORMAT:
        raise ArtifactError(f"format {manifest.get('format')!r} != "
                            f"{FORMAT!r} at {path!r}")
    version = manifest.get("version")
    if not isinstance(version, int) or not MIN_VERSION <= version <= VERSION:
        raise ArtifactError(f"unsupported artifact version {version!r} "
                            f"(reader supports {MIN_VERSION}..{VERSION}) "
                            f"at {path!r}")
    return manifest


def _npz_key(key: str) -> str:
    # '/'-separated keys would become nested zip members inside an npz
    return key.replace("/", ".")


def _tuning_crc(tuning: dict) -> int:
    """CRC32 over the canonical JSON of the tuning payload, so a
    hand-edited or corrupted plan is rejected."""
    blob = json.dumps({"key": tuning["key"], "plan": tuning["plan"]},
                      sort_keys=True, separators=(",", ":"))
    return zlib.crc32(blob.encode("utf-8"))


def save_packed(path: str, packed: BCNNPacked, *,
                provenance: dict | None = None,
                tuning: dict | None = None) -> str:
    """Write ``packed`` as a versioned artifact directory at ``path``;
    returns the manifest path.

    ``provenance``: caller fields recorded beside the fold entry point,
    the torch version and the creation time. ``tuning``: an optional
    ``kernels/autotune.py::tuning_section`` payload, stored with its
    schema version and CRC.

    Commit protocol: the arrays land in a new uniquely named npz first;
    the atomic rename of the manifest, which names that npz, is the single
    commit point, so a crash leaves the old artifact or the new one, never
    a mix. The previous generation's weights file is kept (a reader that
    already holds the old manifest can finish); older ones and aborted
    saves are removed by the next successful save.
    """
    os.makedirs(path, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    leaves: dict[str, Any] = {}
    for key, leaf in walk(packed):
        if leaf is None:
            leaves[key] = {"kind": "none"}
        elif isinstance(leaf, torch.Tensor):
            arr = leaf.detach().cpu().numpy()
            arrays[_npz_key(key)] = arr
            leaves[key] = {"kind": "array", "npz": _npz_key(key),
                           "shape": list(arr.shape),
                           "dtype": str(arr.dtype), "crc": crc32_array(arr)}
        else:
            leaves[key] = {"kind": "static", "value": leaf,
                           "type": type(leaf).__name__}
    weights_file = f"{WEIGHTS_PREFIX}{time.time_ns():016x}.npz"
    manifest = {
        "format": FORMAT, "version": VERSION,
        "weights_file": weights_file,
        "structure": {"n_convs": len(packed.convs),
                      "n_fcs": len(packed.fcs)},
        "leaves": leaves,
        "provenance": {"fold": "core/bcnn.py::fold_model",
                       "torch": torch.__version__,
                       "created_unix": time.time(),
                       **(provenance or {})},
    }
    if tuning is not None:
        manifest["tuning"] = {"tuning_version": TUNING_VERSION,
                              "key": tuning["key"], "plan": tuning["plan"],
                              "crc": _tuning_crc(tuning)}
    mpath = os.path.join(path, MANIFEST)
    prev_weights = None
    try:
        with open(mpath) as f:
            prev_weights = json.load(f).get("weights_file")
    except (OSError, json.JSONDecodeError):
        pass                            # no (readable) previous generation
    with open(os.path.join(path, weights_file), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mpath + ".tmp", mpath)
    for fname in os.listdir(path):
        if fname.startswith(WEIGHTS_PREFIX) and \
                fname not in (weights_file, prev_weights):
            try:
                os.remove(os.path.join(path, fname))
            except OSError:
                pass                    # a concurrent cleaner got there
    return mpath


def load_tuning(path_or_manifest) -> dict | None:
    """The tuning payload ``{"key", "plan"}`` of an artifact directory or
    an already loaded manifest; None when there is no section or its
    schema is newer than this reader. A CRC mismatch raises
    ``ArtifactError``."""
    manifest = (path_or_manifest if isinstance(path_or_manifest, dict)
                else load_manifest(path_or_manifest))
    tuning = manifest.get("tuning")
    if tuning is None or tuning.get("tuning_version") != TUNING_VERSION:
        return None
    payload = {"key": tuning.get("key"), "plan": tuning.get("plan")}
    if _tuning_crc(payload) != tuning.get("crc"):
        raise ArtifactError("tuning section CRC mismatch — corrupt or "
                            "hand-edited plan; refusing to use it")
    return payload


def walk(packed: BCNNPacked):
    """Yield (key, leaf) for every leaf of the packed tree, arrays and
    statics alike, in the manifest's order and with its keys."""
    for f in bconv.FpConvParams._fields:
        yield f"conv1/{f}", getattr(packed.conv1, f)
    for i, c in enumerate(packed.convs):
        yield f"convs/{i}/w_words", c.w_words
        yield f"convs/{i}/thr/c", c.thr.c
        yield f"convs/{i}/thr/flip", c.thr.flip
        yield f"convs/{i}/k", c.k
        yield f"convs/{i}/w_words_hw", c.w_words_hw
        yield f"convs/{i}/fh", c.fh
        yield f"convs/{i}/fw", c.fw
    for j, fc in enumerate(packed.fcs):
        yield f"fcs/{j}/w_words", fc.w_words
        yield f"fcs/{j}/thr/c", fc.thr.c
        yield f"fcs/{j}/thr/flip", fc.thr.flip
        yield f"fcs/{j}/k", fc.k
    yield "fc3_w_words", packed.fc3_w_words
    for f in BNParams._fields:
        yield f"fc3_bn/{f}", getattr(packed.fc3_bn, f)
    yield "fc3_k", packed.fc3_k


def packed_from_numpy(leaves: dict[str, Any]) -> BCNNPacked:
    """Build a CPU ``BCNNPacked`` from leaves keyed like the reference's
    ``core/bcnn_artifact.py::_walk`` ("conv1/w", "convs/0/w_words",
    "convs/0/thr/c", "convs/0/k", …, "fc3_bn/eps", "fc3_k"): arrays as
    numpy, statics by value, absent optional leaves as None."""
    def get(key: str):
        if key not in leaves:
            raise ArtifactError(f"leaf {key!r} missing")
        v = leaves[key]
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.array(v))     # owned, writable copy
        return v

    n_convs = sum(1 for k in leaves if k.startswith("convs/")
                  and k.endswith("/w_words"))
    n_fcs = sum(1 for k in leaves if k.startswith("fcs/")
                and k.endswith("/w_words"))
    conv1 = bconv.FpConvParams(
        **{f: get(f"conv1/{f}") for f in bconv.FpConvParams._fields})
    convs = tuple(bconv.BConvPacked(
        w_words=get(f"convs/{i}/w_words"),
        thr=NBThreshold(c=get(f"convs/{i}/thr/c"),
                        flip=get(f"convs/{i}/thr/flip")),
        k=get(f"convs/{i}/k"), w_words_hw=get(f"convs/{i}/w_words_hw"),
        fh=get(f"convs/{i}/fh"), fw=get(f"convs/{i}/fw"))
        for i in range(n_convs))
    fcs = tuple(blinear.BLinearPacked(
        w_words=get(f"fcs/{j}/w_words"),
        thr=NBThreshold(c=get(f"fcs/{j}/thr/c"),
                        flip=get(f"fcs/{j}/thr/flip")),
        k=get(f"fcs/{j}/k")) for j in range(n_fcs))
    return BCNNPacked(
        conv1=conv1, convs=convs, fcs=fcs,
        fc3_w_words=get("fc3_w_words"),
        fc3_bn=BNParams(**{f: get(f"fc3_bn/{f}") for f in BNParams._fields}),
        fc3_k=get("fc3_k"))


def load_packed(path: str) -> BCNNPacked:
    """Restore a ``BCNNPacked`` (CPU tensors) bit-exactly from an artifact
    directory, after checking every array leaf's shape, dtype and CRC32."""
    manifest = load_manifest(path)
    wpath = os.path.join(path, manifest["weights_file"])
    if not os.path.isfile(wpath):
        raise ArtifactError(f"weights file {manifest['weights_file']!r} "
                            f"referenced by the manifest is missing at "
                            f"{path!r}")
    with np.load(wpath) as npz:
        arrays = dict(npz)
    leaves: dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        if meta["kind"] == "none":
            leaves[key] = None
        elif meta["kind"] == "static":
            leaves[key] = meta["value"]
        else:
            arr = arrays.get(meta["npz"])
            if arr is None:
                raise ArtifactError(f"array {key!r} missing from "
                                    f"{manifest['weights_file']!r}")
            if list(arr.shape) != meta["shape"] or \
                    str(arr.dtype) != meta["dtype"]:
                raise ArtifactError(
                    f"array {key!r}: stored {arr.shape}/{arr.dtype} != "
                    f"manifest {meta['shape']}/{meta['dtype']}")
            if crc32_array(arr) != meta["crc"]:
                raise ArtifactError(f"CRC mismatch for {key!r} at {path!r}")
            leaves[key] = arr
    structure = manifest.get("structure", {})
    packed = packed_from_numpy(leaves)
    if (len(packed.convs), len(packed.fcs)) != (
            structure.get("n_convs"), structure.get("n_fcs")):
        raise ArtifactError(f"structure {structure} does not match the "
                            f"leaves at {path!r}")
    return packed
