"""Work of the paper's Table 2 BCNN, counted from its layer shapes, whatever
kernels run it.

A bit-MAC is one XNOR and one accumulate, 2 ops, as the paper and the
A100's binary rate count them. Bytes: each binary layer's input and output
bit maps at one bit an activation, its packed weights once a launch, its
thresholds (float32 + a flag byte a channel), FC-3's float32 logits.
"""
from h100bench.work import peaks

# (H, W, C_in, C_out, pool) at the layer's input, 3x3 SAME convs
CONVS = ((32, 32, 3, 128, False), (32, 32, 128, 128, True),
         (16, 16, 128, 256, False), (16, 16, 256, 256, True),
         (8, 8, 256, 512, False), (8, 8, 512, 512, True))
FCS = ((8192, 1024), (1024, 1024), (1024, 10))


def layer_macs() -> list[int]:
    """MACs per image of CONV-1..6 and FC-1..3, in order."""
    convs = [h * w * co * 9 * ci for h, w, ci, co, _ in CONVS]
    return convs + [i * o for i, o in FCS]


def ops_per_image() -> int:
    """Ops of one image through all nine layers (2 per MAC): 1.2339 GOP."""
    return 2 * sum(layer_macs())


def binary_layer_bounds_s(batch: int) -> float:
    """Least device time of the eight binary layers (CONV-2..6, FC-1..3,
    the layers K1-K5 compute) on ``batch`` images at the 1-bit peak."""
    total = 0.0
    macs = layer_macs()
    for i, (h, w, ci, co, pool) in enumerate(CONVS[1:], start=1):
        out_hw = (h // 2) * (w // 2) if pool else h * w
        nbytes = (batch * (h * w * ci + out_hw * co) / 8
                  + co * 9 * ci / 8 + co * 5)
        total += peaks.bound_s(2 * macs[i] * batch, peaks.B1_OPS, nbytes)
    for j, (fi, fo) in enumerate(FCS):
        out_bytes = fo * 4 if j == len(FCS) - 1 else fo / 8
        nbytes = batch * (fi / 8 + out_bytes) + fi * fo / 8 + fo * 5
        total += peaks.bound_s(2 * macs[6 + j] * batch, peaks.B1_OPS,
                               nbytes)
    return total
