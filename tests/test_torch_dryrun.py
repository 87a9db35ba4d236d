"""The port's dry run (``launch/dryrun.py``, ``dryrun_lib.py``,
``op_analysis.py``) against the live reference's device-free parts
(``repro/launch/dryrun_lib.py`` and ``hlo_analysis.py``; never
``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512 host
devices).

Equal to the reference: ``model_flops_for``, ``cells_for``, the ring
model (``link_bytes_for``, and ``parse_collectives`` on HLO lines), the
abstract parameter bytes of every arch and the shapes of every cell's
inputs. The traced FLOPs of one full-width Qwen3-8B layer are held
against the analytic ``pipeline.layer_costs``; one whole 16×16 cell runs
through the CLI.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import dryrun_lib as jlib
from repro.launch import hlo_analysis as jhlo
from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, dryrun_lib, op_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.parallel import pipeline as pp
from repro_torch.train.tree import leaves_with_path

ARCHS = configs.ARCH_NAMES
CELLS = [(a, s.name) for a in ARCHS for s in configs.get_shapes(a)]
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, whose thread pools would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shape_of(arch: str, name: str, package=configs):
    return next(s for s in package.get_shapes(arch) if s.name == name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_inputs_equal_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    s, js = shape_of(arch, shape), shape_of(arch, shape, jconfigs)
    assert dryrun_lib.model_flops_for(cfg, s) == jlib.model_flops_for(jcfg,
                                                                      js)
    want = [tuple(x.shape) for x in jax.tree.leaves(jlib.input_specs(jcfg,
                                                                     js))]
    got = [tuple(x.shape) for _, x in leaves_with_path(
        dryrun_lib.input_specs(cfg, s)) if x is not None]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_param_bytes_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in dryrun_lib.cells_for(arch)] == [
        (s.name, s.seq_len, s.global_batch, s.kind)
        for s in jlib.cells_for(arch)]
    want = sum(x.size * x.dtype.itemsize
               for x in jax.tree.leaves(jlib.abstract_params(jcfg)))
    got = sum(x.numel() * x.element_size() for _, x in leaves_with_path(
        dryrun_lib.abstract_params(cfg)))
    assert got == want


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_packed_serving_param_bytes_equal_reference(arch):
    cfg = configs.get_config(arch, quant="binary_weights")
    jcfg = jconfigs.get_config(arch, quant="binary_weights")
    want = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(
        jlib.abstract_params(jcfg, serving_packed=True)))
    got = sum(x.numel() * x.element_size() for _, x in leaves_with_path(
        dryrun_lib.abstract_params(cfg, serving_packed=True)))
    assert got == want


@pytest.mark.parametrize("op", COLLECTIVES)
def test_ring_model_equals_reference(op):
    for n in (1, 2, 4, 8, 16, 256):
        for nbytes in (4096, 12345):
            assert op_analysis.link_bytes_for(op, nbytes, n) == \
                jhlo.link_bytes_for(op, nbytes, n)
    # and dryrun_lib.parse_collectives' model of an HLO line
    for n in (2, 4, 16):
        group = ",".join(map(str, range(n)))
        line = (f"  %c = f32[256,4]{{1,0}} {op}(f32[256,4]{{1,0}} %p), "
                f"replica_groups={{{{{group}}}}}")
        (got,) = jlib.parse_collectives(line)
        assert got["group"] == n and got["out_bytes"] == 4096
        assert op_analysis.link_bytes_for(op, 4096, n) == got["link_bytes"]


def one_layer_flops(s: int, *, as_k7: bool) -> float:
    cfg = configs.get_config("qwen3-8b")
    with dryrun_lib._fake_mode():
        params = tf.init_params(cfg.with_(n_layers=1),
                                torch.Generator().manual_seed(0))
        lp = tf._layer(params["stack0_dense_attn"], 0)
        x = torch.empty((1, s, cfg.d_model), dtype=torch.bfloat16)
        counter = op_analysis.OpCounter()
        with torch.no_grad(), counter:
            if as_k7:
                with counter.attention_as_k7():
                    tf._apply_dense_attn(lp, cfg, x, torch.arange(s)[None])
            else:
                tf._apply_dense_attn(lp, cfg, x, torch.arange(s)[None])
    return counter.costs.flops


def test_traced_layer_flops_against_layer_costs():
    """One full-width Qwen3-8B layer at S = 4096. ``layer_costs`` counts
    every (query, key) pair: 4·S·d a token for the scores and PV, with d
    = H·hd here. The plain attention computes all S² pairs too, so its
    trace is ``layer_costs`` × tokens. K7 computes only the causal
    S(S+1)/2 pairs, so the trace the dry run takes (``attention_as_k7``)
    sits below it by exactly 4·H·hd·(S² − S(S+1)/2): 7.4% at this S."""
    cfg = configs.get_config("qwen3-8b")
    s = 4096
    analytic = pp.layer_costs(cfg, s)[0] * s
    plain = one_layer_flops(s, as_k7=False)
    assert abs(plain - analytic) <= 0.01 * analytic
    assert plain == analytic
    k7 = one_layer_flops(s, as_k7=True)
    gap = 4 * cfg.n_heads * cfg.head_dim * (s * s - s * (s + 1) // 2)
    assert k7 == analytic - gap
    assert 0.07 < gap / analytic < 0.08


def test_local_prefill_report():
    """The one-device report of a Qwen3-8B prefill (1, 4096): params and
    tokens resident, per-device numbers undivided, no collective."""
    cfg = configs.get_config("qwen3-8b")
    shape = InputShape("prefill_4k", 4096, 1, "prefill")
    res = dryrun_lib.run_cell("qwen3-8b", shape,
                              mesh=mesh_lib.make_local_mesh("cpu"))
    assert res.ok, res.error
    params = sum(x.numel() * x.element_size() for _, x in leaves_with_path(
        dryrun_lib.abstract_params(cfg)))
    assert res.mesh == "1x1" and res.arg_bytes == params + 4096 * 8
    assert res.coll_link_bytes == 0 and res.t_collective == 0
    assert res.fits and 0 < res.temp_bytes < 10e9
    # 36 layers as K7 runs them (the test above), the head at the last
    # position only (prefill returns its logits)
    layer = one_layer_flops(4096, as_k7=True)
    assert res.hlo_flops == 36 * layer + 2 * cfg.d_model * cfg.vocab_size
    assert res.bottleneck == "compute"


def test_cli_writes_a_cell(tmp_path, capsys):
    out = tmp_path / "cells"
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    assert "[ok]   qwen3-8b" in capsys.readouterr().out
    res = json.loads((out / "qwen3-8b__decode_32k__16x16__none.json")
                     .read_text())
    assert res["ok"] and res["fits"] and res["error"] == ""
    assert res["bottleneck"] == "memory"
    assert res["coll_counts"] == {"all-reduce": 72}    # 2 a layer, TP only
    for k in ("unpack_credit", "convert_credit", "xla_flops", "xla_bytes"):
        assert res[k] == 0
    assert set(res) == set(dryrun_lib.CellResult.__dataclass_fields__)
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert "[skipped-by-design] qwen3-8b long_500k" in \
        capsys.readouterr().out
    assert len(dryrun_lib.load_results(str(out))) == 1


def test_hw_is_the_h100_data_sheet():
    hw = dryrun_lib.HW
    assert (hw["peak_flops"], hw["hbm_bw"], hw["hbm_bytes"]) == (
        989e12, 3.35e12, 80e9)
    assert dryrun_lib.link_bw(8) == 450e9 and dryrun_lib.link_bw(16) == 50e9
    assert np.isclose(op_analysis.link_bytes_for("all-reduce", 100, 4), 150)
