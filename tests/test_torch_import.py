"""The PyTorch port stands alone: importing it pulls in neither jax nor
hpslam_tpu, no port file (nor chip_smoke.py) imports them, and the entry
points refuse to drift onto the CPU."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hpslam_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_import_pulls_in_neither_jax_nor_reference():
    mods = _port_modules()
    # the multi-device modules are among those imported
    assert {"hpslam_tpu_torch.parallel", "hpslam_tpu_torch.parallel.mesh",
            "hpslam_tpu_torch.parallel.knn_tp"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'hpslam_tpu' or m.startswith('hpslam_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_sources_do_not_mention_jax_or_reference_imports():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+hpslam_tpu\b"
                     r"(?!_torch)|from\s+hpslam_tpu\b(?!_torch))|"
                     r"\bhpslam_tpu\.(?!\w*_torch)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, fs in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in fs if f.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            for m in pat.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_entry_points_refuse_cpu_drift(monkeypatch):
    from hpslam_tpu_torch.device import resolve_device
    from hpslam_tpu_torch.ops import fused_mlp, knn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # a wrapper given a tensor neither on the CPU nor on CUDA raises
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        knn.topk_rows(x, None, 2)
    row = torch.zeros((2, 5 * 5 + 7 + 5 * 4 + 4), device="meta")
    with pytest.raises(ValueError):
        fused_mlp.nicer_fused_maploss(
            torch.zeros((2, 4 * 16), device="meta"),
            torch.zeros((2, 12), device="meta"), [], row,
            torch.zeros((2, 1), device="meta"), [], (None, None), 5, 2,
            True, 5, 4, 8, 0.1, True, False, 0.1)
    with pytest.raises(ValueError):
        fused_mlp.nicer_fused_geo(x[:, :3], x, [], None, 5, 2)
    with pytest.raises(ValueError):
        fused_mlp.nicer_fused_trackloss(
            torch.zeros((2, 6), device="meta"),
            torch.zeros((2, 12), device="meta"),
            torch.zeros((2, 2 * 5 + 6 + 3 * 5 * 8), device="meta"),
            torch.zeros((2, 5 * 8 * 16), device="meta"), [], [], (None, None),
            5, 2, 5, 8, 8, 0.1, 0, False, True)


def test_smoke_refuses_without_cuda_and_outside_the_repo(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, str(tmp_path / "chip_smoke.py"))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
