"""Import hygiene and device discipline of the PyTorch port.

* Every ``repro_torch`` module, and ``chip_smoke.py`` (imported without
  running its ``main``), loads in a fresh interpreter without pulling in
  any ``jax*`` module or the reference package ``repro``.
* Entry points asked for the GPU on a host without one raise instead of
  running on the CPU; ``chip_smoke.py`` exits non-zero with no result
  line when there is no CUDA device or no repository around it.
"""
import importlib.util
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _port_modules() -> list[str]:
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_no_jax_and_no_reference():
    modules = _port_modules()
    assert {"repro_torch.kernels.ops", "repro_torch.serve.bcnn_engine",
            "repro_torch.launch.serve_bcnn",
            "repro_torch.core.bcnn_artifact", "repro_torch.models.xnor_lm",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.configs.xnor_lm_tiny",
            "repro_torch.kernels.flash_attention",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.configs.base",
            "repro_torch.models.mla", "repro_torch.models.moe",
            "repro_torch.configs.deepseek_v2_lite_16b",
            "repro_torch.configs.deepseek_v2_236b",
            "repro_torch.configs.qwen3_8b", "repro_torch.configs.yi_6b",
            "repro_torch.configs.glm4_9b",
            "repro_torch.configs.phi4_mini_3_8b",
            "repro_torch.train.bcnn_train", "repro_torch.train.checkpoint",
            "repro_torch.train.optimizer", "repro_torch.train.tree",
            "repro_torch.data.pipeline",
            "repro_torch.launch.train_bcnn", "repro_torch.core.throughput",
            "repro_torch.parallel.pipeline",
            "repro_torch.parallel.bcnn_pipeline",
            "repro_torch.parallel.bcnn_data_parallel",
            "repro_torch.models.rwkv6", "repro_torch.models.mamba2",
            "repro_torch.configs.rwkv6_3b", "repro_torch.configs.zamba2_7b",
            "repro_torch.configs.phi3_vision_4_2b",
            "repro_torch.configs.whisper_medium",
            "repro_torch.serve.packing", "repro_torch.train.train_loop",
            "repro_torch.train.elastic",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_lib",
            "repro_torch.launch.op_analysis", "repro_torch.parallel.act",
            "repro_torch.parallel.sharding"} <= set(modules)
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or m.startswith('jax'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_or_reference():
    pattern = re.compile(r"\s*(import|from)\s+(jax\w*|repro)(\.|\s|$)")
    for path in [ROOT / "chip_smoke.py", *(SRC / "repro_torch").rglob("*.py")]:
        for line in path.read_text().splitlines():
            assert not pattern.match(line), f"{path}: {line}"


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    from repro_torch.core import bcnn
    from repro_torch.launch import serve, serve_bcnn
    from repro_torch.models import xnor_lm
    from repro_torch.serve.bcnn_engine import BCNNEngine
    packed = bcnn.fold_model(bcnn.init(torch.Generator().manual_seed(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BCNNEngine.from_packed(packed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bcnn.make_packed_forward(packed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_bcnn.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_bcnn.main(["--requests", "1", "--pipeline-stages", "2",
                         "--data-shards", "1", "--offline"])
    from repro_torch.parallel import bcnn_data_parallel, bcnn_pipeline
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        bcnn_pipeline.make_pipelined_forward(packed, n_stages=2)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        bcnn_data_parallel.make_sharded_forward(packed)
    cfg = xnor_lm.XnorLMConfig(vocab_size=32, d_model=32, d_ff=32)
    lm = xnor_lm.fold(cfg, xnor_lm.init(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xnor_lm.make_serving_engine(cfg, lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1"])
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServingEngine
    dense = configs.get_config("qwen3-8b", smoke=True)
    params = transformer.init_params(dense, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(dense, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-8b", "--smoke", "--requests", "1"])
    from repro_torch.launch import train as train_launch
    from repro_torch.train import optimizer, train_loop
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.init_train_state(dense, torch.Generator(),
                                    optimizer.AdamW())


def test_init_matches_reference_distributions():
    from repro_torch.core import bcnn
    p = bcnn.init(torch.Generator().manual_seed(0))
    assert p.conv1.w.shape == (128, 3, 3, 3)
    assert abs(float(p.conv1.w.std()) - 0.1) < 0.01
    shapes = [tuple(c.w.shape) for c in p.convs]
    assert shapes == [(o, 3, 3, i) for i, o, _ in bcnn.CONV_SPECS[1:]]
    assert [tuple(f.w.shape) for f in p.fcs] == [
        (o, i) for i, o in bcnn.FC_SPECS]
    for layer in p.convs + p.fcs:
        w = layer.w.numpy()
        assert w.min() >= -1.0 and w.max() <= 1.0 and abs(w.mean()) < 0.05
        assert np.all(layer.bn_var.numpy() == 1.0)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_names_every_kernel():
    spec = importlib.util.spec_from_file_location("chip_smoke_probe",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from repro_torch.kernels import _build
    assert set(mod.SOURCES) == set(_build.SIGNATURES)
    for name, (source, replaces) in mod.SOURCES.items():
        assert (ROOT / source).is_file()
        path, line = replaces.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        # a variant's name is its TPU kernel's plus a suffix ("_tc")
        assert text.startswith(f"def {name.removesuffix('_tc')}(")
