"""The plain references against the port's CPU path (the test may import
both; the references import nothing of the port), and their controls."""
import numpy as np
import pytest
import torch

from h100bench import programs, weights
from h100bench.reference import bcnn_plain, deepseek_v2_plain

SEED = 2 ** 32 + 5


@pytest.fixture(scope="module")
def bcnn_case():
    latent = weights.bcnn_params(SEED, "cpu")
    imgs = weights.images(SEED, 6, "cpu")
    return latent, imgs


def test_bcnn_reference_is_the_ports_packed_forward_bit_for_bit(bcnn_case):
    from repro_torch.core import bcnn
    latent, imgs = bcnn_case
    packed = programs.bcnn_packed(latent)
    got = bcnn.forward_packed(packed, imgs, path="xla").numpy()
    want = bcnn_plain.logits(latent, imgs).numpy()
    np.testing.assert_array_equal(got, want)


def test_bcnn_reference_is_the_ports_float_oracle(bcnn_case):
    """forward_eval, the port's float +-1 graph, computes the binary
    layers' norms in float32: equal to the reference wherever no
    pre-activation sits within float32 rounding of a threshold, and close
    everywhere."""
    from repro_torch.core import bcnn, bconv, blinear
    latent, imgs = bcnn_case

    def f(p):
        return {k: p[k] for k in ("w", "bn_mean", "bn_var", "bn_gamma",
                                  "bn_beta")}
    params = bcnn.BCNNParams(
        conv1=bconv.FpConvParams(**f(latent["conv1"])),
        convs=tuple(bconv.BConvParams(**f(p)) for p in latent["convs"]),
        fcs=tuple(blinear.BLinearParams(**f(p)) for p in latent["fcs"]))
    got = bcnn.forward_eval(params, imgs)
    want = bcnn_plain.logits(latent, imgs)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_bcnn_control_misses(bcnn_case):
    latent, imgs = bcnn_case
    want = bcnn_plain.logits(latent, imgs).numpy()
    ctrl = bcnn_plain.logits(latent, imgs, dtype=torch.bfloat16).numpy()
    assert np.all(np.any(ctrl != want, axis=-1))


def deepseek_case(dtype):
    from repro_torch import configs
    from repro_torch.models import transformer
    mcfg = configs.get_config("deepseek-v2-lite-16b", smoke=True).with_(
        dtype="float32" if dtype == torch.float32 else "bfloat16")
    sizes = programs.lm_file_sizes(mcfg)
    params = weights.deepseek_params(sizes, SEED, "cpu", dtype=dtype)
    toks = weights.token_pool(SEED, 2, 40, sizes["vocab_size"], "cpu")
    with torch.no_grad():
        got = transformer.prefill(mcfg, params, toks)[:, -1].float()
    return sizes, params, toks, got


def rel(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=-1)
                  / torch.linalg.vector_norm(want, dim=-1)).max())


def test_deepseek_tree_has_the_ports_layout():
    from repro_torch import configs
    from repro_torch.models import transformer
    mcfg = configs.get_config("deepseek-v2-lite-16b", smoke=True)
    want = transformer.init_params(mcfg, torch.Generator().manual_seed(0))
    got = weights.deepseek_params(programs.lm_file_sizes(mcfg), 0, "cpu")

    def shapes(t, pre=""):
        if isinstance(t, dict):
            return {k2: v for k, v in t.items()
                    for k2, v in shapes(v, f"{pre}/{k}").items()}
        return {pre: (tuple(t.shape), t.dtype)}
    assert shapes(got) == shapes(want)


def test_deepseek_reference_is_the_ports_prefill_in_float32():
    sizes, params, toks, got = deepseek_case(torch.float32)
    want = deepseek_v2_plain.last_logits(sizes, params, toks)
    assert rel(got, want) < 1e-4


def test_deepseek_fp8_control_reads_far_above_the_program():
    sizes, params, toks, got = deepseek_case(torch.float32)
    want = deepseek_v2_plain.last_logits(sizes, params, toks)
    ctrl = deepseek_v2_plain.last_logits(sizes, params, toks, quant="fp8")
    assert rel(ctrl, want) > 100 * rel(got, want)
