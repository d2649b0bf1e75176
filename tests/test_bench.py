"""bench.py's measurement modes on the CPU, at small sizes."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402


def test_in_turns_times_every_arm_every_round():
    arms = bench.in_turns([lambda: bench.flagship(12, 20, False),
                           lambda: bench.flagship(16, 20, False)], rounds=3)
    assert [w.name for w, _, _ in arms] == ["izhikevich_12x12_xla",
                                            "izhikevich_16x16_xla"]
    for _, setup, rates in arms:
        assert setup > 0 and len(rates) == 3 and min(rates) > 0


def test_in_turns_reverses_the_order_every_other_round():
    order = []

    def arm(name):
        work = bench.Workload(name, lambda n: order.append(name),
                              lambda: [], 1)
        return lambda: (work, None)

    bench.in_turns([arm("a"), arm("b"), arm("c")], rounds=3)
    assert order == list("abc") + list("abc") + list("cba") + list("abc")


def test_gate_and_settings_arms():
    """The gate compares XLA with the kernel at four sizes; the settings
    mode compares two XLA unrolls and four kernel launch shapes at two."""
    assert len(bench.gate_arms()) == 8
    assert len(bench.settings_arms()) == 12


def test_kernel_launches_refuses_another_length():
    work, _ = bench.kernel_launches(8, 4, 4, 1)
    with pytest.raises(ValueError, match="compiled for 4"):
        work.run(5)


@pytest.mark.parametrize("args", [[], ["--gate"], ["--settings"]])
def test_bench_refuses_to_run_without_a_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")]
                          + args, capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0 and "needs a GPU" in proc.stderr
