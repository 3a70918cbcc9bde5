"""chip_smoke.py's contract that a CPU run can check: it refuses any
platform but a GPU (no CPU fallback), prints no result line then, and
its rate and output helpers read Simulation's timings correctly."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.require_gpu(jax.devices())


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_gpu(tmp_path, alone):
    """Run as the user would, from the repo and from a directory that
    holds the script and nothing else of the repo."""
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert '"ok"' not in res.stdout


def test_steady_rate_excludes_first_step():
    class Sim:
        timings = {"particle_steps": 1000, "wall": 12.0,
                   "first_step_particle_steps": 100,
                   "first_step_wall_s": 3.0}
    assert chip_smoke.steady_rate(Sim()) == pytest.approx(100.0)
