#!/usr/bin/env python3
"""Where a block of a CUDA-core popcount kernel spends its time on the
card: phase timestamps.

    python3 benchmarks/torch_vpu_phases.py k3    # K3, CONV-2..6
    python3 benchmarks/torch_vpu_phases.py k5    # K5 vpu, both pairs

Builds the kernel's source alone with ``REPRO_PHASES`` defined (thread 0
of every block then writes ``%globaltimer``, ``%clock64`` and its SM at
each ``REPRO_PHASE`` of ``csrc/bits.cuh``) into a library of its own under
``kernels/build/``, runs it at batch 4 with eq. 8 fused, holds each output
against ``kernels/ref.py``, and prints per case: the device time per call
(CUDA events behind a sleep kernel, as ``chip_smoke.py::device_ms``), the
blocks and SMs used, the blocks an SM holds at once, the kernel's span
from the first block's start to the last block's end, the spread of block
starts, the SM clock the blocks ran at (their ``%clock64`` cycles over
their ``%globaltimer`` nanoseconds, mean over the blocks), and the mean
of each phase over the blocks.

``k3``: K3 (``xnor_conv.cu``) at the Table 2 convs CONV-2..6, with the
launch plan of ``kernels/xnor_conv.py::vpu_plan``; phases

    start-up   kernel start -> copies issued (mbarrier, TMA, cp.async)
    wait       -> filter rows and halo landed (thresholds loaded meanwhile)
    compute    -> every warp's XOR-popcounts and stores done

``k5``: K5 vpu (``xnor_conv_fused.cu``) at both Table 2 pairs (CONV-3/4,
CONV-5/6) at every legal tile; phases

    start-up   kernel start -> copies issued (prologue, TMA and cp.async)
    tables     -> position tables built
    wait       -> conv A's filters and halo landed, peers started
    conv A     -> conv A done, its words stored in every rank's map
    exchange   -> the cluster barrier after which every map is complete
    conv B     -> conv B done (thresholds, pool, stores)

A later kernel adds a ``drive_*`` function and an entry of ``KERNELS``.
Prints the card's name and power limit first and last. Needs one CUDA
device and nvcc; the timestamps cost each block a few global stores (and
K3 a barrier), so the device time printed here is for the stamped build,
not the one that is served.
"""
from __future__ import annotations

import argparse
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
# Table 2 binary convs (H=W, C, O), 3x3, stride 1: chip_smoke.CONV_SHAPES
CONVS = [(32, 128, 128), (16, 128, 256), (16, 256, 256), (8, 256, 512),
         (8, 512, 512)]
# Table 2 fused pairs (H=W, C, OA, OB), 3x3, pooled: chip_smoke.PAIR_SHAPES
PAIRS = [(16, 128, 256, 256), (8, 256, 512, 512)]
MAX_BLOCKS = 1 << 16


def build(source: str, table: str, entry: str) -> ctypes.CDLL:
    """``source`` alone, built with -DREPRO_PHASES; binds ``entry`` and
    the stamp table's reader ``<table>_read``."""
    out = _build.BUILD_DIR / f"{table}_stamped"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{table}.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH, *_build.FLAGS,
                    "-DREPRO_PHASES", "-shared", "-I", str(_build.CSRC),
                    "-o", str(lib), str(_build.CSRC / source)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    read = getattr(dll, f"{table}_read")
    read.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    read.restype = ctypes.c_int
    return dll


def held_at_once(t0, t1, sm_of) -> int:
    """The most blocks one SM holds at the same time."""
    held = 0
    for sm in np.unique(sm_of):
        ev = sorted([(s, 1) for s in t0[sm_of == sm]]
                    + [(e, -1) for e in t1[sm_of == sm]])
        live = 0
        for _, d in ev:
            live += d
            held = max(held, live)
    return held


def report(dll, table: str, run, n_blocks: int, phases: list[str]) -> str:
    """Device time of ``run`` and the phases of its blocks' stamps."""
    dev_us = statistics.median(autotune.device_times(run, 21)) * 1e6
    run()
    torch.cuda.synchronize()
    stamps = np.zeros((MAX_BLOCKS, 16), dtype=np.uint64)
    if getattr(dll, f"{table}_read")(stamps.ctypes.data, stamps.nbytes):
        raise RuntimeError("reading the phase stamps failed")
    ph = stamps[:n_blocks].astype(np.int64)
    last = len(phases)
    t0, t1, sm_of = ph[:, 0], ph[:, last], ph[:, 7]
    mhz = ((ph[:, 8 + last] - ph[:, 8]) / (t1 - t0)).mean() * 1e3
    means = [(ph[:, i + 1] - ph[:, i]).mean() / 1e3 for i in range(last)]
    return (f"{dev_us:.2f} us on the device; {n_blocks} blocks on "
            f"{len(np.unique(sm_of))} SMs, at most "
            f"{held_at_once(t0, t1, sm_of)} an SM at once; span "
            f"{(t1.max() - t0.min()) / 1e3:.2f} us, block starts spread "
            f"over {(t0.max() - t0.min()) / 1e3:.2f} us, SM clock "
            f"{mhz:.0f} MHz; block {((t1 - t0).mean() / 1e3):.2f} us = "
            + ", ".join(f"{name} {m:.2f}" for name, m in zip(phases, means)))


def rand_bits(g, shape, dev):
    return torch.randint(0, 2, shape, generator=g, dtype=torch.int8).to(dev)


def rand_thr(g, n, k, dev):
    return (torch.randint(0, k + 1, (n,), generator=g).float().to(dev),
            torch.randint(0, 2, (n,), generator=g).bool().to(dev))


def drive_k3(dll, dev, g) -> None:
    for h, c, o in CONVS:
        a_bits = rand_bits(g, (N_IMAGES, h, h, c), dev)
        w_bits = rand_bits(g, (o, 3, 3, c), dev)
        thr_c, thr_f = rand_thr(g, o, 9 * c, dev)
        want = ref.norm_binarize_ref(
            ref.xnor_conv2d_ref(a_bits, w_bits, stride=1, pad=1), thr_c,
            thr_f)
        aw = bitpack.pack_bits(a_bits)
        ww = kconv.pack_conv_weights(bitpack.decode_pm1(w_bits))
        out = torch.empty((N_IMAGES, h, h, o), dtype=torch.int8, device=dev)

        def run():
            rc = dll.xnor_conv2d_vpu(
                aw.data_ptr(), ww.data_ptr(), thr_c.data_ptr(),
                thr_f.data_ptr(), out.data_ptr(), N_IMAGES, h, h, c // 32,
                o, 3, 3, 1, 1, 1, h, h, 0,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: error {rc}")

        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit(f"torch_vpu_phases: K3 at {h}x{h} C={c} O={o} "
                             f"differs from the plain version")
        plan = kconv.vpu_plan(N_IMAGES, h, h, c // 32, o, 3, 3, 1)
        print(f"K3 CONV {h}x{h} C={c} O={o}, th {plan.th}: "
              + report(dll, "k3_phases", run, plan.blocks,
                       ["start-up", "wait", "compute"]))


def drive_k5(dll, dev, g) -> None:
    for h, c, oa, ob in PAIRS:
        a_bits, wa_bits, wb_bits = (rand_bits(g, (N_IMAGES, h, h, c), dev),
                                    rand_bits(g, (oa, 3, 3, c), dev),
                                    rand_bits(g, (ob, 3, 3, oa), dev))
        thr = [*rand_thr(g, oa, 9 * c, dev), *rand_thr(g, ob, 9 * oa, dev)]
        want = ref.xnor_conv2d_pair_ref(
            a_bits, wa_bits, wb_bits, thr_a_c=thr[0], thr_a_flip=thr[1],
            thr_b_c=thr[2], thr_b_flip=thr[3], pool_b=True)
        aw = bitpack.pack_bits(a_bits)
        waw = kconv.pack_conv_weights(bitpack.decode_pm1(wa_bits))
        wbw = kconv.pack_conv_weights(bitpack.decode_pm1(wb_bits))
        geom = dict(pf=2, fha=3, fwa=3, cwa=c // 32, fhb=3, fwb=3, oa=oa)
        default = kfused.pick_tiles(h // 2, h // 2, **geom)
        print(f"K5 vpu pair {h}x{h} C={c} OA={oa} OB={ob} (default tile "
              f"{default})")
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
                raise SystemExit(f"torch_vpu_phases: K5 vpu tile ({th}, "
                                 f"{tw}) differs from the plain version")
            n_blocks = (-(-h // 2 // th) * -(-h // 2 // tw)
                        * kfused.mxu_split(oa, ob)[0] * N_IMAGES)
            print(f"  tile ({th}, {tw}): " + report(
                dll, "vpu_phases", run, n_blocks,
                ["start-up", "tables", "wait", "conv A", "exchange",
                 "conv B"]))


# kernel -> (source, stamp table, entry point, drive function)
KERNELS = {
    "k3": ("xnor_conv.cu", "k3_phases", "xnor_conv2d_vpu", drive_k3),
    "k5": ("xnor_conv_fused.cu", "vpu_phases", "xnor_conv2d_pair_vpu",
           drive_k5),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_vpu_phases: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    source, table, entry, drive = KERNELS[args.kernel]
    drive(build(source, table, entry), torch.device("cuda"),
          torch.Generator().manual_seed(0))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
