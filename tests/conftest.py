import os

# Tests run on the CPU, on a virtual 8-device mesh, so multi-device
# sharding paths are exercised without accelerators; chip_smoke.py runs the
# main path on a GPU.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
# Unrolled scan bodies are bit-exact vs rolled (pure scheduling) but cost
# ~4x the XLA:CPU compile time, which dominates the suite; force rolled
# loops for tests that leave scan_unroll on auto.
os.environ.setdefault("SNN_SCAN_UNROLL", "1")

import jax  # noqa: E402

# Persistent compile cache: XLA:CPU compile time dominates the suite.  The
# directory is JAX_COMPILATION_CACHE_DIR when set, else a fixed path in the
# checkout (.jax_cache/ is gitignored).
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache", "tests"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
