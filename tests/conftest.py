"""Test configuration: run on a simulated 8-device CPU mesh by default.

Distributed code paths (shard_map point sharding, frame data-parallelism)
are exercised against XLA's host-platform device simulation, exactly as
they compile for a real device mesh.  Pallas kernels run in interpret
mode here.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere (the ``gpu``
fixture decides at run time).  Run them on a machine with a card:
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")

# Best-effort native-lib build so the C++ IO fast path is EXERCISED by
# the suite (test_native.py skips without it) instead of silently
# shipping untested.  ~1 s with g++; failures fall back to skipping.
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_so = os.path.join(_repo, "native", "libpcr_native.so")
if not os.path.exists(_so):
    import subprocess

    _mk = subprocess.run(["make", "-C", os.path.join(_repo, "native")],
                         capture_output=True, timeout=120, check=False)
    if _mk.returncode != 0 and not os.path.exists(_so):
        # Don't let a broken native build silently downgrade 9 tests
        # to skips — surface it at collection time.
        import warnings

        warnings.warn(
            "native build FAILED — test_native.py will be skipped:\n"
            + _mk.stderr.decode()[-800:], stacklevel=1)


# ---------------------------------------------------------------------------
# Fast/full test tiers.  The fast tier (`pytest -m "not full"`) is the
# inner-loop gate; tests/slow_tests.txt holds the measured node ids of the
# slow ones (regenerate: `pytest --durations=60 -q`, copy everything
# slower than ~15 s).  The end-of-PR gate runs the whole suite.
# ---------------------------------------------------------------------------


def _slow_ids():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "slow_tests.txt")
    try:
        with open(path) as f:
            return {ln.strip() for ln in f if ln.strip()
                    and not ln.startswith("#")}
    except OSError:
        return set()


def pytest_collection_modifyitems(config, items):
    import pytest

    slow = _slow_ids()
    if not slow:
        return
    mark = pytest.mark.full
    for item in items:
        # Node ids are repo-root-relative ("tests/test_x.py::...").
        nid = item.nodeid
        if nid in slow or f"tests/{nid}" in slow:
            item.add_marker(mark)
