#!/usr/bin/env python3
"""Where a block of K5 vpu spends its time on the card: phase timestamps.

    python3 benchmarks/torch_vpu_phases.py

Builds ``src/repro_torch/kernels/csrc/xnor_conv_fused.cu`` with
``REPRO_VPU_PHASES`` defined (thread 0 of every vpu block then writes
``%globaltimer`` at each ``VPU_PHASE`` and its SM) into a library of its
own under ``kernels/build/``, runs the fused pair on path "vpu" at both
Table 2 path pairs (CONV-3/4, CONV-5/6) at batch 4 at every legal tile,
holds each output against ``kernels/ref.py::xnor_conv2d_pair_ref``, and
prints per tile: the device time per call (CUDA events behind a sleep
kernel, as ``chip_smoke.py::device_ms``), the blocks and SMs used, the
kernel's span from the first block's start to the last block's end, the
blocks an SM holds at once, and the mean of each phase over the blocks:

    start-up   kernel start -> copies issued (prologue, TMA and cp.async)
    tables     -> position tables built
    wait       -> conv A's filters and halo landed, peers started
    conv A     -> conv A done, its words stored in every rank's map
    exchange   -> the cluster barrier after which every map is complete
    conv B     -> conv B done (thresholds, pool, stores)

Prints the card's name and power limit first. Needs one CUDA device and
nvcc; the timestamps cost each block a few global stores, so the device
time printed here is for the stamped build, not the one that is served.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import bitpack  # noqa: E402
from repro_torch.kernels import _build, autotune, ref  # noqa: E402
from repro_torch.kernels import xnor_conv as kconv  # noqa: E402
from repro_torch.kernels import xnor_conv_fused as kfused  # noqa: E402

N_IMAGES = 4
# Table 2 fused pairs (H=W, C, OA, OB), 3x3, pooled: chip_smoke.PAIR_SHAPES
PAIRS = [(16, 128, 256, 256), (8, 256, 512, 512)]
PHASES = ["start-up", "tables", "wait", "conv A", "exchange", "conv B"]
MAX_BLOCKS = 1 << 16


def build() -> ctypes.CDLL:
    """The stamped library: xnor_conv_fused.cu alone, -DREPRO_VPU_PHASES."""
    out = _build.BUILD_DIR / "vpu_phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libvpu_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH, *_build.FLAGS,
                    "-DREPRO_VPU_PHASES", "-shared", "-I", str(_build.CSRC),
                    "-o", str(lib), str(_build.CSRC / "xnor_conv_fused.cu")],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.xnor_conv2d_pair_vpu.argtypes = _build.SIGNATURES[
        "xnor_conv2d_pair_vpu"]
    dll.xnor_conv2d_pair_vpu.restype = ctypes.c_int
    dll.vpu_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    dll.vpu_phases_read.restype = ctypes.c_int
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_vpu_phases: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dll = build()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for h, c, oa, ob in PAIRS:
        def bits(shape):
            return torch.randint(0, 2, shape, generator=g,
                                 dtype=torch.int8).to(dev)
        a_bits, wa_bits, wb_bits = (bits((N_IMAGES, h, h, c)),
                                    bits((oa, 3, 3, c)), bits((ob, 3, 3, oa)))
        ka, kb = 9 * c, 9 * oa
        thr = [torch.randint(0, ka + 1, (oa,), generator=g).float().to(dev),
               torch.randint(0, 2, (oa,), generator=g).bool().to(dev),
               torch.randint(0, kb + 1, (ob,), generator=g).float().to(dev),
               torch.randint(0, 2, (ob,), generator=g).bool().to(dev)]
        want = ref.xnor_conv2d_pair_ref(
            a_bits, wa_bits, wb_bits, thr_a_c=thr[0], thr_a_flip=thr[1],
            thr_b_c=thr[2], thr_b_flip=thr[3], pool_b=True)
        aw = bitpack.pack_bits(a_bits)
        waw = kconv.pack_conv_weights(bitpack.decode_pm1(wa_bits))
        wbw = kconv.pack_conv_weights(bitpack.decode_pm1(wb_bits))
        geom = dict(pf=2, fha=3, fwa=3, cwa=c // 32, fhb=3, fwb=3, oa=oa)
        default = kfused.pick_tiles(h // 2, h // 2, **geom)
        print(f"pair {h}x{h} C={c} OA={oa} OB={ob} at batch {N_IMAGES} "
              f"(default tile {default}); phases: mean us over the blocks")
        for th, tw in autotune.tile_candidates(h // 2, h // 2, **geom):
            out = torch.empty((N_IMAGES, h // 2, h // 2, ob),
                              dtype=torch.int8, device=dev)

            def run():
                rc = dll.xnor_conv2d_pair_vpu(
                    aw.data_ptr(), waw.data_ptr(), thr[0].data_ptr(),
                    thr[1].data_ptr(), wbw.data_ptr(), thr[2].data_ptr(),
                    thr[3].data_ptr(), out.data_ptr(), N_IMAGES, h, h,
                    c // 32, oa, ob, 3, 3, 3, 3, 2, th, tw, 0, 0,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: error {rc}")

            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"torch_vpu_phases: tile ({th}, {tw}) "
                                 f"differs from the plain version")
            dev_us = statistics.median(
                autotune.device_times(run, 21)) * 1e6
            run()
            torch.cuda.synchronize()
            stamps = np.zeros((MAX_BLOCKS, 8), dtype=np.uint64)
            if dll.vpu_phases_read(stamps.ctypes.data, stamps.nbytes):
                raise RuntimeError("reading the phase stamps failed")
            n_blocks = (-(-h // 2 // th) * -(-h // 2 // tw)
                        * kfused.mxu_split(oa, ob)[0] * N_IMAGES)
            ph = stamps[:n_blocks].astype(np.int64)
            t0, t1 = ph[:, 0], ph[:, 6]
            span = (t1.max() - t0.min()) / 1e3
            sms = np.unique(ph[:, 7])
            # blocks an SM holds at once: the most overlapping intervals
            held = 0
            for sm in sms:
                ev = sorted([(s, 1) for s in t0[ph[:, 7] == sm]]
                            + [(e, -1) for e in t1[ph[:, 7] == sm]])
                live = 0
                for _, d in ev:
                    live += d
                    held = max(held, live)
            means = [(ph[:, i + 1] - ph[:, i]).mean() / 1e3
                     for i in range(6)]
            print(f"  tile ({th}, {tw}): {dev_us:.2f} us on the device, "
                  f"{n_blocks} blocks on {len(sms)} SMs, span {span:.2f} "
                  f"us, at most {held} blocks an SM at once; block "
                  f"{((t1 - t0).mean() / 1e3):.2f} us = " + ", ".join(
                      f"{name} {m:.2f}" for name, m in zip(PHASES, means)))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
