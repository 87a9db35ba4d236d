"""The port's tuner (``kernels/autotune.py``), its artifact section
(``core/bcnn_artifact.py``) and the serving entry points that use them,
on the CPU at full Table 2 width.

* Under a fake clock every interval is equal, so races go to the first
  candidate and the winners are deterministic.
* The candidate space obeys the legality rules: paths by backend,
  "direct" where ``resolve_strategy`` allows it, tiles that fit shared
  memory with ``pick_tiles``'s choice among them.
* A candidate whose output differs from the plain CPU path is not
  eligible; the tuned plan's logits equal the default plan's exactly.
* The tuning section round-trips; a CRC tamper raises, a newer section
  version is ignored, a foreign key falls back to "default". Artifacts
  cross between the port and the reference in both directions.

On the card the same tuner races the CUDA kernels (``chip_smoke.py``
phase 4).
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import bcnn_artifact as jart
from repro.core import bconv as jbconv
from repro.core import blinear as jblinear
from repro.core import execution_plan as jxp
from repro.kernels import autotune as jat
from repro_torch.core import bcnn, bcnn_artifact, bconv, execution_plan as xp
from repro_torch.kernels import autotune as at
from repro_torch.kernels import xnor_conv_fused as kfused
from repro_torch.launch import serve_bcnn
from repro_torch.serve.bcnn_engine import BCNNEngine


class FakeTimer:
    """Monotone counter clock: every measured interval is 1.0."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def tune(packed, **kw):
    return at.autotune_packed(packed, device="cpu", timer=FakeTimer(),
                              reps=1, warmup=0, batch=1, **kw)


@pytest.fixture(scope="module")
def packed():
    return bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(0)))


@pytest.fixture(scope="module")
def tuned(packed):
    report = {}
    return tune(packed, report=report), report


@pytest.fixture(scope="module")
def images():
    return torch.from_numpy(
        np.random.default_rng(3).random((3, 32, 32, 3)).astype(np.float32))


def test_candidate_space_obeys_legality(packed):
    assert at.backend_paths("cuda") == ("vpu", "mxu")
    assert at.backend_paths("cpu") == ("xla",)
    space = at.enumerate_candidates(packed, "cuda")
    assert space["paths"] == ("vpu", "mxu")
    assert sorted(space["convs"]) == [1, 2, 3, 4, 5]
    for idx, conv in space["convs"].items():
        fp = packed.convs[idx - 1]
        c = fp.k // (fp.fh * fp.fw)
        assert conv["strategies"] == ("direct", "im2col")
        assert at.strategy_candidates(fp._replace(w_words_hw=None), c) == \
            ("im2col",)
        assert bconv.resolve_strategy("auto", c, fp) == "direct"
    assert sorted(space["pairs"]) == [2, 4]
    for i, pair in space["pairs"].items():
        pg = xp.pair_geometry(packed, i)
        assert pair["pool_b"] is True
        tiles = pair["tiles"]
        assert kfused.pick_tiles(pg["ho"], pg["wo"], **pg["geom"]) in tiles
        assert all(kfused.tile_fits(th, tw, **pg["geom"]) for th, tw in tiles)
        assert all(th & (th - 1) == 0 and tw & (tw - 1) == 0
                   and th <= pg["ho"] and tw <= pg["wo"] for th, tw in tiles)
    assert len(space["pairs"][2]["tiles"]) == 16       # 8x8 pooled output
    assert len(space["pairs"][4]["tiles"]) == 9        # 4x4 pooled output
    # a geometry whose largest tiles overflow shared memory drops them
    geom = dict(pf=2, fha=3, fwa=3, cwa=32, fhb=3, fwb=3, oa=2048)
    big = at.tile_candidates(8, 8, **geom)
    assert (8, 8) not in big and (4, 8) in big


def test_fake_timer_tuning_is_deterministic(packed, tuned):
    plan, report = tuned
    again = tune(packed)
    assert again == plan
    assert plan.tuned and plan.path == "xla"
    # equal times: the first strategy ("direct") wins every conv, and the
    # fused pairs (1.0 each) beat their sequential folds (2.0 each)
    assert plan.conv_strategy == (None,) + ("direct",) * 5 + (None,) * 3
    assert plan.conv_fusion
    assert plan.group_tiles == xp.default_group_tiles(
        packed, bcnn.plan_layer_groups(conv_fusion=True))
    assert report["n_candidates"] == report["n_eligible"] == 5 * 2 + 3 + 2
    # (median, spread) sums: 5 convs + 3 FCs, each 1.0 with a spread of
    # TIE_REL x 1.0 (one rep has no interquartile range)
    tie = at.TIE_REL
    assert report["path_totals"] == {"xla": pytest.approx((8.0, 8 * tie))}
    assert report["fused_s"] == pytest.approx((2.0, 2 * tie))
    assert report["sequential_s"] == pytest.approx((4.0, 4 * tie))
    assert report["key"] == xp.plan_cache_key(packed, "cpu")
    assert report["plan"] == xp.plan_to_dict(plan)


def test_wrong_candidate_is_not_eligible(packed, monkeypatch):
    """A strategy whose output differs from the plain path may not win:
    im2col is corrupted here, so its rows are ineligible and direct wins
    even when im2col is timed faster."""
    real = bconv.apply_packed

    def corrupt(fp, a_bits, **kw):
        out = real(fp, a_bits, **kw)
        return 1 - out if kw.get("strategy") == "im2col" else out

    monkeypatch.setattr(at.bconv, "apply_packed", corrupt)
    report = {}
    plan = tune(packed, report=report)
    rows = {r["candidate"]: r for r in report["candidates"]}
    for idx in range(1, 6):
        assert rows[f"conv{idx}:xla:im2col"]["eligible"] is False
        assert rows[f"conv{idx}:xla:im2col"]["median_s"] is None
        assert rows[f"conv{idx}:xla:direct"]["eligible"] is True
    assert report["n_eligible"] == report["n_candidates"] - 5
    assert plan.conv_strategy[1:6] == ("direct",) * 5
    ref = torch.tensor([[1, 0]], dtype=torch.int8)
    rows = []
    scores = at._race([("bad", lambda: 1 - ref), ("good", lambda: ref)],
                      ref, device=torch.device("cpu"), timer=FakeTimer(),
                      reps=1, warmup=0, rows=rows)
    assert scores == {"good": (1.0, at.TIE_REL)}
    assert at._pick(scores) == "good"
    assert [r["eligible"] for r in rows] == [False, True]
    assert rows[0]["median_s"] is None and rows[1]["spread_s"] == at.TIE_REL


def test_pick_keeps_the_heuristic_choice_within_noise():
    """The first (heuristic) candidate is displaced only by one that is
    faster by more than the two spreads together."""
    assert at._pick({}) is None
    assert at._pick({"mxu": (1.00, 0.03), "vpu": (0.95, 0.03)}) == "mxu"
    assert at._pick({"mxu": (1.00, 0.03), "vpu": (0.90, 0.03)}) == "vpu"
    assert at._pick({"off": (1.0, 0.01), "on": (0.5, 0.2), "x": (0.7, 0.0)}
                    ) == "on"
    # of two challengers within noise of each other, the earlier one wins
    assert at._pick({"a": (2.0, 0.1), "b": (1.1, 0.0), "c": (1.0, 0.2)}
                    ) == "b"
    # spread: the interquartile range, floored at TIE_REL of the median
    clock = iter([0.0, 1.0, 1.0, 3.0, 3.0, 4.0, 4.0, 14.0])
    median, spread = at.measure(lambda: None, device=torch.device("cpu"),
                                timer=lambda: next(clock), reps=4, warmup=0)
    assert (median, spread) == (2.0, 10.0 - 1.0)     # times 1, 2, 1, 10
    assert at.measure(lambda: None, device=torch.device("cpu"),
                      timer=FakeTimer(), reps=3, warmup=0) == (1.0,
                                                               at.TIE_REL)


# CONV-3/4's K5-mxu tiles as an H100 timed them at batch 4 (ms, the
# tuning phase of chip_smoke.py): (1, 8) lies 6% above the fastest, (2,
# 4), at the edge of the band of two TIE_REL spreads
CONV34_MXU_MS = {(1, 1): 0.0868, (1, 2): 0.0649, (1, 4): 0.0556,
                 (1, 8): 0.0516, (2, 1): 0.0649, (2, 2): 0.0548,
                 (2, 4): 0.0485, (2, 8): 0.0531, (4, 1): 0.0556,
                 (4, 2): 0.0486, (4, 4): 0.0531, (4, 8): 0.0557,
                 (8, 1): 0.0516, (8, 2): 0.0532, (8, 4): 0.0558,
                 (8, 8): 0.0790}


def test_tile_race_order_puts_larger_squarer_tiles_first():
    tiles = tuple(CONV34_MXU_MS)
    order = at.tile_race_order(tiles, (1, 2))
    assert order[0] == (1, 2) and sorted(order) == sorted(tiles)
    areas = [th * tw for th, tw in order[1:]]
    assert areas == sorted(areas, reverse=True)
    assert [t for t in order if t[0] * t[1] == 8] == [(2, 4), (4, 2), (1, 8),
                                                      (8, 1)]
    assert at.tile_race_order(tiles, (9, 9))[0] == (8, 8)


def test_a_tile_at_the_band_edge_does_not_split_two_tunings():
    """With (1, 8) just inside or just beyond the noise band of the fastest
    tile, the race order of ``tile_candidates`` picks (1, 8) or (2, 4) (two
    tunings of one card disagreed so); ``tile_race_order`` picks (2, 4)
    either way."""
    def pick(order, t18):
        ms = dict(CONV34_MXU_MS)
        ms[(1, 8)] = t18
        return at._pick({t: (ms[t], at.TIE_REL * ms[t]) for t in order})

    edge = 0.0485 * (1 + at.TIE_REL) / (1 - at.TIE_REL)
    tiles = tuple(CONV34_MXU_MS)
    old = at._first(tiles, (1, 2))
    assert [pick(old, edge * f) for f in (0.999, 1.001)] == [(1, 8), (2, 4)]
    new = at.tile_race_order(tiles, (1, 2))
    assert {pick(new, edge * f) for f in (0.99, 0.999, 1.001, 1.01)} == {
        (2, 4)}


def test_tuned_plan_bit_exact(packed, tuned, images):
    plan, _ = tuned
    want = bcnn.forward_packed(packed, images, path="xla")
    assert torch.equal(bcnn.forward_packed(packed, images, plan=plan), want)
    eng = BCNNEngine.from_packed(packed, n_slots=2, plan=plan, device="cpu")
    assert eng.plan is plan
    rids = [eng.submit(img.numpy()) for img in images]
    out = eng.run()
    np.testing.assert_array_equal(np.stack([out[r] for r in rids]),
                                  want.numpy())


# ----------------------------------------------------------------- artifact

def test_tuning_section_roundtrip(tmp_path, packed, tuned):
    plan, _ = tuned
    section = at.tuning_section(packed, plan, "cpu")
    bcnn_artifact.save_packed(str(tmp_path), packed, tuning=section)
    loaded = bcnn_artifact.load_tuning(str(tmp_path))
    assert loaded == json.loads(json.dumps(section))
    got, source = at.plan_for_host(bcnn_artifact.load_packed(str(tmp_path)),
                                   loaded, "cpu")
    assert (got, source) == (plan, "cached")
    manifest = bcnn_artifact.load_manifest(str(tmp_path))
    assert manifest["tuning"]["tuning_version"] == bcnn_artifact.TUNING_VERSION
    assert manifest["provenance"]["torch"] == torch.__version__
    assert bcnn_artifact.load_tuning(manifest) == loaded
    bcnn_artifact.save_packed(str(tmp_path / "plain"), packed)
    assert bcnn_artifact.load_tuning(str(tmp_path / "plain")) is None


def test_tuning_crc_tamper_and_newer_version(tmp_path, packed, tuned):
    plan, _ = tuned
    bcnn_artifact.save_packed(str(tmp_path), packed,
                              tuning=at.tuning_section(packed, plan, "cpu"))
    mpath = tmp_path / bcnn_artifact.MANIFEST
    manifest = json.loads(mpath.read_text())
    manifest["tuning"]["plan"]["path"] = "vpu"
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(bcnn_artifact.ArtifactError, match="CRC"):
        bcnn_artifact.load_tuning(str(tmp_path))
    manifest["tuning"]["tuning_version"] = bcnn_artifact.TUNING_VERSION + 1
    mpath.write_text(json.dumps(manifest))
    assert bcnn_artifact.load_tuning(str(tmp_path)) is None


def test_foreign_key_falls_back_to_default(packed, tuned):
    plan, _ = tuned
    section = at.tuning_section(packed, plan, "cpu")
    default = xp.default_plan(packed, "cpu")
    for field, value in (("backend", "cuda"), ("device_kind", "TPU v5 lite"),
                         ("geometry", "00000000")):
        foreign = {**section, "key": {**section["key"], field: value}}
        assert at.plan_for_host(packed, foreign, "cpu") == (default,
                                                            "default")
    malformed = {**section, "plan": {"path": "xla"}}
    assert at.plan_for_host(packed, malformed, "cpu") == (default, "default")
    assert at.plan_for_host(packed, None, "cpu") == (default, "default")


def _jax_packed(seed):
    p = bcnn.numpy_params(seed)

    def conv(cls, q):
        return cls(*[jnp.asarray(getattr(q, f)) for f in cls._fields])
    return jbcnn.fold_model(jbcnn.BCNNParams(
        conv1=conv(jbconv.FpConvParams, p.conv1),
        convs=tuple(conv(jbconv.BConvParams, q) for q in p.convs),
        fcs=tuple(conv(jblinear.BLinearParams, q) for q in p.fcs)))


def test_port_artifact_loads_in_reference(tmp_path, packed, tuned):
    plan, _ = tuned
    bcnn_artifact.save_packed(str(tmp_path), packed,
                              tuning=at.tuning_section(packed, plan, "cpu"),
                              provenance={"steps": 7})
    loaded = jart.load_packed(str(tmp_path))
    want = dict(bcnn_artifact.walk(packed))
    got = dict(jart._walk(loaded))
    assert list(got) == list(want)
    for key, leaf in want.items():
        if isinstance(leaf, torch.Tensor):
            arr = np.asarray(got[key])
            assert arr.dtype == leaf.numpy().dtype and arr.shape == leaf.shape
            np.testing.assert_array_equal(arr, leaf.numpy(), err_msg=key)
        else:
            assert got[key] == leaf, key
    assert jart.load_tuning(str(tmp_path))["plan"] == xp.plan_to_dict(plan)
    assert jart.load_manifest(str(tmp_path))["provenance"]["steps"] == 7


def test_reference_cpu_tuning_is_default_on_the_card(tmp_path, packed,
                                                     monkeypatch):
    """A reference artifact tuned on its CPU loads in the port; the key
    (backend "cpu", device kind "cpu", the shared geometry) matches the
    port's CPU, where its "xla" plan is valid, and never a card."""
    jpk = _jax_packed(0)
    jplan = jxp.build_plan(jpk, conv_fusion=True, backend="cpu", tuned=True)
    jart.save_packed(str(tmp_path), jpk,
                     tuning=jat.tuning_section(jpk, jplan, "cpu"))
    tuning = bcnn_artifact.load_tuning(str(tmp_path))
    assert tuning["key"]["backend"] == "cpu"
    tpk = bcnn_artifact.load_packed(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    plan, source = at.plan_for_host(tpk, tuning, "cuda")
    assert source == "default" and plan.path == "mxu"
    assert at.plan_for_host(tpk, tuning, "cpu") == (
        xp.plan_from_dict(jxp.plan_to_dict(jplan)), "cached")


# ------------------------------------------------------- engine and the CLI

def test_fused_engine_serves_unfused_logits(packed, images):
    outs = []
    for fusion in (False, True):
        eng = BCNNEngine.from_packed(packed, n_slots=2, conv_fusion=fusion,
                                     device="cpu")
        assert eng.plan.conv_fusion is fusion
        rids = [eng.submit(img.numpy()) for img in images]
        res = eng.run()
        outs.append(np.stack([res[r] for r in rids]))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_serve_cli_tunes_exports_then_hits_cache(tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(at, "autotune_packed", functools.partial(
        at.autotune_packed, timer=FakeTimer(), reps=1, warmup=0, batch=1))
    art = str(tmp_path / "art")
    assert serve_bcnn.main(["--device", "cpu", "--requests", "2", "--slots",
                            "2", "--conv-fusion", "--autotune",
                            "--export-artifact", art]) == 0
    out = capsys.readouterr().out
    assert "tuning: measured 15 candidate(s) (15 eligible)" in out
    assert "(with tuning section)" in out and "served 2/2" in out
    assert bcnn_artifact.load_tuning(art)["key"]["backend"] == "cpu"
    assert serve_bcnn.main(["--device", "cpu", "--requests", "2", "--slots",
                            "2", "--artifact", art, "--autotune"]) == 0
    out = capsys.readouterr().out
    assert "tuning: cache hit" in out and "tuning: measured" not in out
    assert "fusion on" in out and "served 2/2" in out
