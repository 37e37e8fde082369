"""The PyTorch port stands alone: importing it pulls in neither jax nor
hpslam_tpu (nor cv2, matplotlib or PIL; wandb only inside
Telemetry.__init__), no port file (nor chip_smoke.py) imports them, and
the entry points refuse to drift onto the CPU."""
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
            "hpslam_tpu_torch.parallel.knn_tp",
            "hpslam_tpu_torch.bench"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from hpslam_tpu_torch.renderer import eval_points\n"
            "from hpslam_tpu_torch.ops.knn import find_neighbors\n"
            "from hpslam_tpu_torch.ops.geometry import (as_intrinsics_matrix, "
            "rotation2quad, get_tensor_from_camera, c2w_to_44, "
            "transform_points, cart2sph, masked_psnr)\n"
            "from hpslam_tpu_torch.ops.sampling import sample_indices, "
            "flat_to_ij\n"
            "from hpslam_tpu_torch.ops.fused_mlp import unflatten_core_like\n"
            "from hpslam_tpu_torch.state import NeuralPointCloud as N\n"
            "assert all(hasattr(N, a) for a in ('index_ntotal', 'cloud_pos', "
            "'cloud_normal', 'get_geo_feats', 'get_col_feats', "
            "'update_geo_feats', 'update_col_feats', 'get_keyframe_dict', "
            "'set_keyframe_dict', 'input_normal', 'input_normal_cartesian', "
            "'find_neighbors'))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'hpslam_tpu' or m.startswith('hpslam_tpu.') "
            "or m == 'bench']\n"
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


def test_cv2_only_inside_the_jpeg_decode():
    """The card's machine has no cv2, and the port decodes JPEG itself
    (native/jpeg.cpp): no port module (nor chip_smoke.py) imports cv2 at
    all, the JPEG decoder and the telemetry module are among the modules
    imported, and importing every module leaves cv2 out."""
    mods = _port_modules()
    assert {"hpslam_tpu_torch.utils.image_io",
            "hpslam_tpu_torch.utils.telemetry",
            "hpslam_tpu_torch.tools.preflight",
            "hpslam_tpu_torch.tools.convert_pretrained"} <= set(mods)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, fs in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not re.search(r"^\s*(import|from)\s+cv2\b", f.read(),
                                 re.M), path
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'cv2' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_wandb_only_inside_telemetry_init():
    """wandb is optional: the one import of it sits in
    utils/telemetry.Telemetry.__init__, and no other port file (nor
    chip_smoke.py) imports it."""
    import ast
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, fs in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in fs if f.endswith(".py")]
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            if not any(n.split(".")[0] == "wandb" for n in names):
                continue
            chain, p = [], parents.get(node)
            while p is not None:
                if isinstance(p, (ast.FunctionDef, ast.ClassDef)):
                    chain.append(p.name)
                p = parents.get(p)
            found.append((os.path.relpath(path, ROOT), chain[::-1]))
    assert found == [(os.path.join("hpslam_tpu_torch", "utils",
                                   "telemetry.py"),
                      ["Telemetry", "__init__"])], found


def test_no_plotting_or_imaging_library():
    """The card's machine has neither matplotlib nor PIL: no port module
    (nor chip_smoke.py) imports them anywhere, at module level or inside a
    function (eval_ate draws its plot on the port's own canvas), the
    visualiser's, meshing, native and ATE modules are among those
    imported, and importing every module leaves both out."""
    mods = _port_modules()
    assert {"hpslam_tpu_torch.utils.visualizer",
            "hpslam_tpu_torch.utils.panels", "hpslam_tpu_torch.native",
            "hpslam_tpu_torch.tools.get_mesh_tsdf_fusion",
            "hpslam_tpu_torch.tools.end_correction",
            "hpslam_tpu_torch.tools.eval_recon",
            "hpslam_tpu_torch.tools.cull_mesh",
            "hpslam_tpu_torch.tools.make_synth_gt_mesh",
            "hpslam_tpu_torch.tools.eval_ate"} <= set(mods)
    pat = re.compile(r"^\s*(import|from)\s+(matplotlib|PIL)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, fs in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'PIL')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_entry_points_refuse_cpu_drift(monkeypatch):
    from hpslam_tpu_torch import bench
    from hpslam_tpu_torch.device import resolve_device
    from hpslam_tpu_torch.ops import fused_mlp, knn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # the benchmark's entry point: CUDA unless --device cpu is given
    with pytest.raises(RuntimeError):
        bench.main([])
    with pytest.raises(RuntimeError):
        bench.main(["--device", "cuda", "--H", "8", "--W", "8"])
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
