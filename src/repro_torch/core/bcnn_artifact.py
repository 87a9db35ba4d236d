"""Reader of the packed-BCNN deployment artifact (counterpart of the
reading half of ``repro/core/bcnn_artifact.py``; the writer comes with
training).

An artifact is one directory: ``manifest.json`` (format name, version,
per-leaf shape / dtype / CRC32 for arrays, the static leaves k / fh / fw /
fc3_k / BN eps by value, the name of the live weights file) and that
``weights-*.npz``. ``load_packed`` checks the format, accepts versions
``MIN_VERSION..VERSION``, verifies every array's CRC32 before anything is
built, and returns the port's ``BCNNPacked`` on the CPU; any mismatch
raises ``ArtifactError``. ``packed_from_numpy`` is the step that carries
weights across: it builds the net from leaves keyed as the reference's
``_walk`` keys them.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core import bconv, blinear
from repro_torch.core.bcnn import BCNNPacked
from repro_torch.core.crc import crc32_array
from repro_torch.core.normbinarize import BNParams, NBThreshold

FORMAT = "bcnn-packed"
VERSION = 2
MIN_VERSION = 1
MANIFEST = "manifest.json"


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
