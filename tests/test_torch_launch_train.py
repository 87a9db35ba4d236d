"""The port's LM training CLI (``repro_torch/launch/train.py``) on the
CPU: the reference's train-driver tests (``tests/test_launch.py``) with
``--device cpu``, a ``--crash-at`` / ``--resume`` run whose final state
is bitwise the straight run's, a checkpoint the reference restores, and
no quiet CPU where there is no GPU."""
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import configs
from repro_torch.launch import train as train_launch
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop, tree

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these smoke-sized tensors: the test runner
    runs several workers side by side, whose thread pools would otherwise
    contend for every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_driver_runs_and_checkpoints(tmp_path, capsys):
    rc = train_launch.main(CPU + [
        "--arch", "yi-6b", "--smoke", "--steps", "4", "--batch", "2",
        "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--log-every", "2"])
    assert rc == 0
    assert sorted(os.listdir(tmp_path))[-1] == "step_00000004"
    out = capsys.readouterr().out
    assert "step     2  loss=" in out and "tok/s=" in out


def test_train_driver_resume(tmp_path, capsys):
    train_launch.main(CPU + [
        "--arch", "yi-6b", "--smoke", "--steps", "2", "--batch", "2",
        "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    rc = train_launch.main(CPU + [
        "--arch", "yi-6b", "--smoke", "--steps", "4", "--batch", "2",
        "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--resume"])
    assert rc == 0
    assert "[resume] restored step 2" in capsys.readouterr().out


def test_train_driver_binary_quant():
    rc = train_launch.main(CPU + [
        "--arch", "qwen3-8b", "--smoke", "--steps", "2", "--batch", "2",
        "--seq", "32", "--quant", "binary_weights", "--microbatches", "2"])
    assert rc == 0


@pytest.mark.parametrize("arch,flags", [
    ("whisper-medium", ["--compress-grads"]),
    ("phi-3-vision-4.2b", ["--microbatches", "2"]),
    ("deepseek-v2-lite-16b", ["--quant", "binary"])])
def test_crash_and_resume_is_bitwise(arch, flags, tmp_path):
    """Straight 4 steps against 2, a simulated crash and a resume to 4:
    the final checkpoints are equal leaf for leaf."""
    common = CPU + ["--arch", arch, "--smoke", "--steps", "4", "--batch",
                    "2", "--seq", "16", "--ckpt-every", "2"] + flags
    a, b = str(tmp_path / "straight"), str(tmp_path / "crashed")
    assert train_launch.main(common + ["--ckpt-dir", a]) == 0
    with pytest.raises(SystemExit, match="simulated fault after step 2"):
        train_launch.main(common + ["--ckpt-dir", b, "--crash-at", "2"])
    assert ck.latest_step(b) == 2
    assert train_launch.main(common + ["--ckpt-dir", b, "--resume"]) == 0
    quant = flags[1] if flags[0] == "--quant" else "none"
    cfg = configs.get_config(arch, smoke=True, quant=quant)
    adamw = opt.AdamW()
    like = train_loop.init_train_state(
        cfg, torch.Generator().manual_seed(0), adamw,
        "--compress-grads" in flags, device="cpu")
    sa, at = ck.restore(a, like)
    sb, bt = ck.restore(b, like)
    assert at == bt == 4
    pairs = list(zip(tree.leaves_with_path(sa), tree.tree_leaves(sb)))
    assert all((x is None and y is None) or torch.equal(x, y)
               for (_, x), y in pairs), [k for (k, x), y in pairs
                                         if x is not None
                                         and not torch.equal(x, y)]
    assert int(sa.opt.step) == 4
    assert (sa.ef is None) == ("--compress-grads" not in flags)


def test_cli_checkpoint_restores_in_the_reference(tmp_path):
    """The CLI's ``TrainState`` checkpoint restores in the reference into
    its own ``TrainState``, bitwise (bf16 leaves included)."""
    d = str(tmp_path)
    assert train_launch.main(CPU + [
        "--arch", "qwen3-8b", "--smoke", "--steps", "2", "--batch", "2",
        "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2",
        "--compress-grads"]) == 0
    jcfg = jconfigs.get_config("qwen3-8b", smoke=True)
    like = jtl.init_train_state(jcfg, jax.random.PRNGKey(1), jopt.AdamW(),
                                compress_grads=True)
    jstate, step = jck.restore(d, like)
    assert step == 2
    cfg = configs.get_config("qwen3-8b", smoke=True)
    ours, _ = ck.restore(d, train_loop.init_train_state(
        cfg, torch.Generator().manual_seed(0), opt.AdamW(), True,
        device="cpu"))
    flat = jck._flatten(jstate)
    leaves = tree.leaves_with_path(ours)
    assert {k for k, _ in leaves} == set(flat)
    assert any(t.dtype == torch.bfloat16 for _, t in leaves)
    for key, t in leaves:
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      np.asarray(flat[key], np.float32))


def test_cli_without_device_cpu_raises_where_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.train(configs.get_config("yi-6b", smoke=True), steps=1)
