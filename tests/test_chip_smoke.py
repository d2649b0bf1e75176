"""chip_smoke.py's phases at small sizes on the CPU.

The script checks the main path on a GPU; here each phase runs on the CPU
with the kernel's plain-JAX reference standing in for the kernel, so a
wrong path, argument or check shows before a GPU run is spent on it.
"""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from spiking_neural_networks_jax.ops import stencil_kernel as sk  # noqa: E402


def test_verify_flow_is_healthy():
    """The verify notes' flow: 5,000 steps of history, V range about
    [-64.4, 30], all 100 neurons fired."""
    shape, vmin, vmax, fired = chip_smoke.verify_flow()
    assert shape == (5000, 10, 10) and fired == 100
    assert -66.0 < vmin < -63.0 and 29.0 < vmax <= 30.0


@pytest.mark.parametrize("rows", [24, 33])
def test_flagship_arms_agree(rows):
    out = chip_smoke.flagship_arms(rows, 60)
    assert set(out) == {False, None}
    assert all(s["steps_per_s"] > 0 for s in out.values())


@pytest.mark.parametrize("rows,k", [(60, None), (50, 1), (70, 3)])
def test_compare_launch_with_reference(rows, k):
    import bench
    _, lat = bench.flagship(rows, 10, use_kernel=False)
    lat.run_lattice(3)
    dv, dw, excluded = chip_smoke.compare_launch(
        lat, sk.izhikevich_multistep_reference, n_steps=k)
    assert dv <= 1e-4 and dw <= 1e-4 and excluded < rows * rows


def test_kernel_vs_xla_phase_with_reference():
    chip_smoke.kernel_vs_xla_phase(
        60, long_steps=300, impl=sk.izhikevich_multistep_reference)


def test_statistics_check_catches_a_difference():
    a = {"v_min": -60.0, "v_max": 29.9, "fired": 1000, "recent": 400}
    chip_smoke.check_statistically_equal(a, dict(a, recent=403))
    with pytest.raises(RuntimeError):
        chip_smoke.check_statistically_equal(a, dict(a, recent=420))
    with pytest.raises(RuntimeError):
        chip_smoke.check_statistically_equal(a, dict(a, v_min=-50.0))


def test_reference_phase_small():
    dv, overlap = chip_smoke.reference_phase(side=8, steps=5, sweeps=2)
    assert dv <= 1e-4 and 0.0 <= overlap <= 1.0


@pytest.mark.parametrize("name,size", [
    ("hh_stdp", (8, 400)), ("reward_network", (8, 1000)),
    ("chemical_network", (8, 1000)), ("closed_loop", (4, 100))])
def test_check_class_small(name, size):
    assert chip_smoke.check_class(name, *size) > 0


def test_multi_phase_on_cpu_mesh():
    chip_smoke.multi_phase(rows=16, steps=20, n_dev=4,
                           devices=jax.devices("cpu"))


def test_script_refuses_to_run_without_a_gpu():
    """Without a GPU the script exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
