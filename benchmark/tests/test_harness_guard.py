"""The import guard compares top-level module names whole."""
import subprocess
import sys

from benchmark import guard
from benchmark.tests.tiny import REPO


def test_whole_top_level_names():
    assert guard.offending(["hpslam_tpu_torch", "hpslam_tpu_torch.slam",
                            "benchmark.run", "jaxtyping", "flaxen"]) == []
    assert guard.offending(["hpslam_tpu.ops"]) == ["hpslam_tpu"]
    assert guard.offending(["jax.numpy", "jaxlib", "flax.linen",
                            "bench"]) == ["bench", "flax", "jax", "jaxlib"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; import benchmark.run, benchmark.harness, "
            "benchmark.check, benchmark.calibrate; "
            "import hpslam_tpu_torch.slam; "
            "from benchmark import guard; print(guard.offending())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.mapping, "
            "benchmark.reference.tracking; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'hpslam_tpu_torch', 'hpslam_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
