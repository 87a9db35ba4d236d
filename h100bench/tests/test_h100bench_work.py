"""The work counts of ``h100bench/work`` against the program's own count
and against figures worked out by hand."""
import pytest

from h100bench import harness
from h100bench.work import attention, bcnn, deepseek, peaks


def test_bcnn_ops_equal_the_programs_count():
    from repro_torch.core import throughput
    assert bcnn.ops_per_image() == throughput.ops_per_image()
    assert sum(bcnn.layer_macs()) == 616_966_144
    assert bcnn.ops_per_image() == 1_233_932_288


def test_bcnn_binary_bound_between_its_terms():
    # the eight binary layers of 64 images: 2 * (616,966,144 - CONV-1's
    # 3,538,944) bit ops at the 1-bit peak, and at most that plus every
    # layer's bytes (the FCs are bound by their weights at this batch)
    t_ops = 64 * 2 * (616_966_144 - 3_538_944) / peaks.B1_OPS
    weights = 9 * (128 * 128 + 128 * 256 + 256 * 256 + 256 * 512
                   + 512 * 512) + 8192 * 1024 + 1024 * 1024 + 1024 * 10
    t_all = t_ops + (64 * 2 * 32 * 32 * 512 + weights) / peaks.HBM_BYTES_PER_S
    assert t_ops < bcnn.binary_layer_bounds_s(64) < t_all


def test_deepseek_flops_of_one_4096_prompt():
    c = harness.config("deepseek-v2-lite-16b")
    # by hand: MLA 2048*3072 + 2048*576 + 2*512*2048 + 2048*2048 =
    # 13,762,560 a layer; layer 0's FFN 3*2048*10944 = 67,239,936; a MoE
    # layer (6 routed + 2 shared) * 3*2048*1408 + 2048*64 = 69,337,088
    per_token = 27 * 13_762_560 + 67_239_936 + 26 * 69_337_088
    assert deepseek.token_params(c) == per_token == 2_241_593_344
    pairs = 4096 * 4097 // 2
    attn = 27 * 2 * 16 * (192 + 128) * pairs
    head = 2 * 2048 * 102_400
    want = 2 * per_token * 4096 + attn + head
    assert deepseek.prefill_flops(c, 1, 4096) == want
    assert want == pytest.approx(20.683e12, rel=1e-3)


def test_attention_count_is_flash_bound_at_equal_widths():
    # chip_smoke.py::flash_bound: 4*B*Hq*hd per kept pair
    assert attention.flops(2, 16, 1024, 128, 128) == \
        4 * 2 * 16 * 128 * (1024 * 1025 // 2)
    assert attention.flops(1, 8, 64, 64, 64, causal=False) == \
        4 * 8 * 64 * 64 * 64
