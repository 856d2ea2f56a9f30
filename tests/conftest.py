"""Shared fixtures.  NOTE: device count must stay 1 here (the dry-run sets
its own 512-device flag in-process); multi-device tests spawn subprocesses
with their own XLA_FLAGS.

``REPRO_LOCKCHECK=1`` arms the runtime lock-discipline checker
(:mod:`repro.analysis.lockcheck`) for the whole session: every
``threading.Lock``/``RLock`` created after this point is tracked, and the
session FAILS at exit if the recorded acquisition-order graph has a cycle
(a latent deadlock), cross-validating the static C002 rule."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

_LOCKCHECK = os.environ.get("REPRO_LOCKCHECK") == "1"
if _LOCKCHECK:
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro.analysis import lockcheck
    lockcheck.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's kernels); "
        "skips elsewhere")


def pytest_sessionfinish(session, exitstatus):
    if not _LOCKCHECK:
        return
    rep = lockcheck.report()
    print(f"\n[lockcheck] {rep['locks']} locks from {rep['sites']} sites, "
          f"{rep['acquisitions']} acquisitions, {len(rep['edges'])} "
          f"order edges, {len(rep['cycles'])} cycles")
    # an exception here fails the run — exactly what the CI gate wants
    lockcheck.assert_acyclic()


def run_with_devices(code: str, n_devices: int, timeout: int = 900) -> str:
    """Run a python snippet in a subprocess with N fake XLA devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=timeout)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="session")
def subproc():
    return run_with_devices
