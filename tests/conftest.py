"""Test environment: CPU backend with 8 virtual devices, float64 enabled.

Multi-device sharding logic is tested the standard JAX way — faking several
devices on the CPU backend via ``--xla_force_host_platform_device_count`` (SURVEY.md §4);
float64 is enabled so parity tests can match the float64 oracle to tight
tolerances.  These env vars must be set before jax initialises.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "true"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Plugins (e.g. jaxtyping) may have imported jax before this conftest ran, in
# which case the env vars above were read too late — set the config directly
# (safe while no backend has been initialised yet).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    import jax

    return jax.devices()


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The suite JIT-compiles several hundred distinct programs in one
    process; around the ~120-program mark jaxlib 0.9.0's CPU backend can
    segfault inside ``backend_compile`` (LLVM JIT code-memory exhaustion —
    the same compilations succeed in a fresh process).  Dropping the
    executable caches per module keeps the resident JIT footprint bounded;
    each module recompiles its own programs anyway."""
    yield
    jax.clear_caches()

    # The solver keeps its own AOT-executable cache (the reference-parity
    # "kernel cache"); drop it too so the freed executables are actually
    # collectable.
    from gpusolve_tpu.solver import vcycle as _vc

    _vc._compiled_cycles.clear()
    import gc

    gc.collect()

