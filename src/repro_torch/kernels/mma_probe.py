"""The tensor-core rate probe (``csrc/mma_probe.cu``): issue-bound loops
of four ``mma.sync`` forms on the current CUDA device, as bit-MACs per
second per card. It decided the MMA form of K2 and K4 (the 1-bit
``.and.popc`` product) and is no kernel of any path; ``chip_smoke.py``
runs it before the kernel checks so every run prints the rates it stands
on.
"""
from __future__ import annotations

import statistics

import torch

from repro_torch.kernels import _build

# form name -> (form index of the launcher, bit-MACs per MMA)
FORMS = {
    "b1 xor.popc": (0, 16 * 8 * 256),
    "b1 and.popc": (1, 16 * 8 * 256),
    "s8": (2, 16 * 8 * 32),
    "s8 + register unpack": (3, 16 * 8 * 32),
}
WARPS_PER_BLOCK = 8      # PROBE_THREADS / 32
CHAINS = 4               # MMAs per warp per round


def rates(blocks_per_sm: int = 4, iters: int = 2048,
          reps: int = 5) -> dict[str, float]:
    """Bit-MACs per second of each form over the whole card: the median of
    ``reps`` launches of ``blocks_per_sm`` blocks per SM, timed by CUDA
    events after one warm-up launch."""
    if not torch.cuda.is_available():
        raise RuntimeError("the MMA rate probe needs a CUDA device")
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    blocks = sms * blocks_per_sm
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, (form, bitmacs) in FORMS.items():
        def launch():
            _build.launch("mma_rate_probe", form, blocks, iters,
                          sink.data_ptr(), stream)
        launch()
        ms = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            launch()
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e))
        mmas = blocks * WARPS_PER_BLOCK * iters * CHAINS
        out[name] = mmas * bitmacs / (statistics.median(ms) * 1e-3)
    return out
