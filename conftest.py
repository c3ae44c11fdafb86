"""Settings of every test run from the repo's root, loaded before
``tests/conftest.py``: each xdist worker's share of the CPUs, JAX's CPU
dispatch run inline, and a time limit on every test."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
from time_limit import TimeLimit  # noqa: E402

# Longest that one test (setup, call and teardown) may run under xdist:
# nearly four times the slowest test under tier-1's load (70-79 s), and a
# fifth of tier-1's 1470 s.
TEST_TIME_LIMIT_S = 300

# Each xdist worker gets its share of the CPUs for torch's (and BLAS's)
# threads, set before either starts its pool; the subprocesses a test
# starts inherit it. At the default of a thread per CPU in every worker,
# several times more spinning OpenMP threads than CPUs share the machine,
# and the port's many small CPU ops crawl. A run without xdist keeps the
# default.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 0))
if _WORKERS:
    os.environ["OMP_NUM_THREADS"] = str(
        max(1, len(os.sched_getaffinity(0)) // _WORKERS))


def pytest_configure(config):
    jax = sys.modules.get("jax")     # imported by tests/conftest.py
    if jax is not None:
        # Run each computation on the CPU inline, before the next is
        # dispatched. Dispatched asynchronously, an interpret-mode Pallas
        # kernel's io_callback (its `store`, reading a jax.Array) and the
        # main thread's next eager op can both wait for good inside
        # XLA:CPU's runtime.
        jax.config.update("jax_cpu_enable_async_dispatch", False)
    config.pluginmanager.register(TimeLimit(TEST_TIME_LIMIT_S), "time_limit")
