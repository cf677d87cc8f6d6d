"""Suite-wide settings on top of tests/conftest.py, for every pytest run in
the repository:

- one JAX compile cache for every xdist worker, holding every program;
- the `slow` marker on the three tests that tier-1 leaves out;
- a per-test time limit that does not count time spent in JAX's
  compile-or-load, which waits on conftest's cross-process compile lock.
"""

import faulthandler
import fcntl
import os
import sys
import threading
import time

import pytest

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")

SLOW = (
    # 360 frames of full SLAM; test_city_drift_short_gate is its tier-1 cut
    "tests/test_long_trajectory.py::test_city_drive_kitti_drift_gated",
    # tools/run_slam.py in a fresh process; TestFuseImuRate runs in tier-1
    "tests/test_imu_rate_fusion.py::test_run_slam_lego_bag_emits_imu_rate_stream",
    # the JAX package against itself: minutes of compile on every run (never
    # cached), holding the compile lock that every other worker waits on
    "tests/test_window_map.py::TestWindowSolve::test_analytic_information_matches_jacfwd_oracle",
)

LIMIT_S = 600
# the cache is pruned to its least recently read entries past this size
CACHE_MAX_BYTES = 512 << 20


def _shared_cache():
    """Points the workers' JAX cache at one directory: conftest keys it by CPU
    and by worker, and its compile lock wraps both the cache read and the
    write, so one process at a time touches the directory, and a program one
    worker compiled is loaded by the others. Every program is cached: the
    suite's eager ops are thousands of programs of about 50 ms each, compiled
    one at a time under that lock, and a load takes a few ms."""
    import jax
    from jax._src import compilation_cache

    suffix = "-" + os.environ.get("PYTEST_XDIST_WORKER", "main")
    path = jax.config.jax_compilation_cache_dir or ""
    if not path.endswith(suffix):
        return None
    path = path.removesuffix(suffix)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    compilation_cache.reset_cache()
    return path


def _prune(path):
    """Deletes the least recently read entries (atime) while the cache is
    larger than CACHE_MAX_BYTES, under the compile lock."""
    if not os.path.isdir(path):
        return
    with open(os.path.join(TESTS, ".xla_compile.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        entries = sorted((e.stat().st_atime, e.stat().st_size, e.path)
                         for e in os.scandir(path) if e.is_file())
        size = sum(s for _, s, _ in entries)
        for _, s, p in entries:
            if size <= CACHE_MAX_BYTES:
                break
            os.remove(p)
            size -= s


def pytest_configure(config):
    global _stderr_fd
    config.addinivalue_line("markers", "nightly: left on two tests, which SLOW below marks slow")
    # tests/conftest.py (which imports jax) is loaded only when tests/ is run
    if "jax" in sys.modules:
        path = _shared_cache()
        if path and not hasattr(config, "workerinput"):
            _prune(path)
        from jax._src import compiler

        compiler.compile_or_get_cached = _uncharged(compiler.compile_or_get_cached)
    # capture is suspended here, so fd 2 is the real stderr; tests swap it later
    _stderr_fd = os.dup(2)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # the oracle reruns itself in a fresh pytest (_WINDOW_ORACLE_INNER=1),
    # which must not deselect it
    if os.environ.get("_WINDOW_ORACLE_INNER") == "1":
        return
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


# Per-test limit: a test whose setup, call and teardown run past LIMIT_S,
# not counting JAX compile-or-load calls, dumps every thread's stack and ends
# its process. Under xdist that is one failure named after the test (the
# worker is replaced and the run goes on), not a suite cut by its outer time
# limit. pytest's own faulthandler_timeout only dumps the stacks.
_stderr_fd = None
_mutex = threading.Lock()
_left = None    # seconds of the running test's budget, None between tests
_since = 0.0    # when the budget last started running
_compiling = 0  # compile-or-load calls in progress in this process


def _arm():
    faulthandler.dump_traceback_later(max(_left, 1.0), exit=True, file=_stderr_fd)


def _uncharged(fn):
    def call(*args, **kwargs):
        global _left, _compiling, _since
        with _mutex:
            if _compiling == 0 and _left is not None:
                faulthandler.cancel_dump_traceback_later()
                _left -= time.monotonic() - _since
            _compiling += 1
        try:
            return fn(*args, **kwargs)
        finally:
            with _mutex:
                _compiling -= 1
                if _compiling == 0 and _left is not None:
                    _since = time.monotonic()
                    _arm()

    return call


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    global _left, _since
    with _mutex:
        _left, _since = float(LIMIT_S), time.monotonic()
        if _compiling == 0:
            _arm()
    try:
        yield
    finally:
        with _mutex:
            _left = None
            faulthandler.cancel_dump_traceback_later()
