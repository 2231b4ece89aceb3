"""Set-up of the suite under tests/ that tests/conftest.py (JAX on the CPU,
8 virtual devices) leaves to the repository's root:

- the JAX package's C planes are built once, in the pytest-xdist controller
  before any worker starts: workers that raced to compile them into one
  temporary file once left one worker without a plane, which then skipped
  tests/test_native.py, and xdist refused the whole run. Their loader sets
  OMP_WAIT_POLICY=passive, which must come before torch loads the OpenMP
  runtime: idle OpenMP threads then sleep instead of spinning.
- PyTorch runs on one thread in every test process: the port's tests are
  small tensors, on which more threads cost far more than they give (one
  prove of tests/test_torch_ntt_kernel.py takes ~9 s on one thread and
  ~6 min on eight).
- every test under tests/ has a time limit (tests/time_limits.py): 300 s,
  or its `time_limit` marker's. LIMITS gives one to tests whose waits for
  their subprocesses need more.
- SLOW marks `slow` the JAX package's own self-checks that take minutes
  (and one that runs only under SVT_SLOW=1 and waits up to 840 s), so
  that tier-1 (`-m 'not slow'`) leaves them out; `-m slow` runs them."""
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"
sys.path.insert(0, str(TESTS))

pytest_plugins = ["time_limits"]

SLOW = {
    ("test_bn254.py", "test_bridge_permute12_matches_host"),
    ("test_native.py", "test_bn254_bridge_native_matches_jax_kernel"),
    ("test_parallel.py", "test_dryrun_multichip_8"),
    ("test_parallel.py", "test_zk20_sharded_multichip"),
    ("test_fuzz_mutations.py", "test_fuzz_batched_zk20"),
    ("test_multihost.py", "test_four_process_verify"),
}
LIMITS = {("test_multihost.py", "test_two_process_verify"): 480}


def _runs_tests(config):
    """Whether this run collects anything under tests/."""
    for arg in config.args:
        path = (config.invocation_params.dir / arg.split("::")[0]).resolve()
        if path == TESTS or TESTS in path.parents or path in TESTS.parents:
            return True
    return False


def pytest_configure(config):
    import time_limits

    config.stash[time_limits.SCOPE] = TESTS
    if not _runs_tests(config):
        return
    from stark_verifier_tpu import native

    native.lib()
    native.bn254_lib()

    import torch

    torch.set_num_threads(1)


@pytest.hookimpl(tryfirst=True)   # before `-m` deselects by mark
def pytest_collection_modifyitems(items):
    for item in items:
        if item.path.parent != TESTS:
            continue
        key = (item.path.name, item.originalname)
        if key in SLOW:
            item.add_marker(pytest.mark.slow)
        if key in LIMITS:
            item.add_marker(pytest.mark.time_limit(LIMITS[key]))
