"""A time limit for every test: its set-up, call and tear-down together.

The limit is DEFAULT_S; `@pytest.mark.time_limit(seconds)` gives a test its
own, up to MAX_S. A test marked `slow` (run with `-m slow`) has no limit
unless it carries the marker, and where a conftest puts a directory under
SCOPE, a test outside it has none either. At the limit SIGALRM raises TimeLimitExceeded
inside the test, and its message holds every thread's stack. A hang inside C
code never returns to Python to take that signal: there `faulthandler`
writes every thread's stack to the run's stderr and ends the process a
grace period later. Under pytest-xdist the worker is reported as crashed
and replaced, and its file's other tests go on in the new worker; the
test that ended its worker, which xdist hands to the new worker again,
then fails at once (a file per running test, under the run's temporary
directory, tells it) instead of hanging once more.

The repository's root conftest.py loads the hooks for the tests under
tests/; `python -m pytest -p time_limits` loads them into another run
(tests/test_time_limits.py)."""
import contextlib
import faulthandler
import hashlib
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import pytest

DEFAULT_S = 300.0
MAX_S = 600.0

SCOPE = pytest.StashKey[Path]()
_DEADLINE = pytest.StashKey[tuple]()
_STDERR = pytest.StashKey[object]()


class TimeLimitExceeded(Exception):
    """A test ran past its time limit."""


def _in_scope(item):
    scope = item.config.stash.get(SCOPE, None)
    return scope is None or scope in item.path.parents


def limit_of(item):
    """The test's limit in seconds, or None for a `slow` test without one
    and for a test outside SCOPE."""
    if not _in_scope(item):
        return None
    mark = item.get_closest_marker("time_limit")
    if mark is None:
        return None if item.get_closest_marker("slow") else DEFAULT_S
    seconds = float(mark.args[0])
    if not 0 < seconds <= MAX_S:
        raise ValueError(f"time_limit({mark.args[0]!r}): the limit must be in (0, {MAX_S:g}] s")
    return seconds


def backstop_s(limit: float) -> float:
    """How long after the limit faulthandler ends a process stuck in C."""
    return min(60.0, limit / 2)


def _stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    return "\n".join(f"Thread {names.get(ident, ident)}:\n" + "".join(traceback.format_stack(frame))
                     for ident, frame in sys._current_frames().items())


def _run_dir(config):
    """Under pytest-xdist, a directory of this run's own; None in a run
    without workers."""
    uid = getattr(config, "workerinput", {}).get("testrunuid")
    return None if uid is None else Path(tempfile.gettempdir()) / f"pytest-time-limits-{uid}"


def _running_file(item):
    """The file that says `item` is running (under pytest-xdist)."""
    run_dir = _run_dir(item.config)
    return None if run_dir is None or not _in_scope(item) else run_dir / hashlib.sha256(item.nodeid.encode()).hexdigest()


@contextlib.contextmanager
def _armed(item, teardown=False):
    """The rest of the test's time on SIGALRM (main thread only) and on the
    faulthandler backstop, for one phase. A tear-down that starts past the
    limit (the test has failed for it) gets the backstop's grace to clean
    up."""
    deadline, limit = item.stash.get(_DEADLINE, (None, None))
    if deadline is None:
        yield
        return
    remaining = deadline - time.monotonic()
    if remaining <= 0:
        remaining = backstop_s(limit) if teardown else 1e-3
    main = threading.current_thread() is threading.main_thread()
    if main:
        def on_alarm(signum, frame):
            raise TimeLimitExceeded(f"{item.nodeid} ran past its time limit of {limit:g} s "
                                    f"(set-up, call and tear-down)\n{_stacks()}")

        previous = signal.signal(signal.SIGALRM, on_alarm)
        signal.setitimer(signal.ITIMER_REAL, remaining)
    faulthandler.dump_traceback_later(remaining + backstop_s(limit), exit=True,
                                      file=item.config.stash[_STDERR])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        if main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def pytest_configure(config):
    # the real stderr, kept past pytest's capture of fd 2
    config.stash[_STDERR] = os.fdopen(os.dup(sys.__stderr__.fileno()), "w")


def pytest_unconfigure(config):
    faulthandler.cancel_dump_traceback_later()
    config.stash[_STDERR].close()
    run_dir = _run_dir(config)
    if run_dir is not None:
        with contextlib.suppress(OSError):   # another worker's test runs, or one ended its worker
            run_dir.rmdir()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    running = _running_file(item)
    if running is not None:
        if running.exists():
            raise TimeLimitExceeded(f"{item.nodeid} ended its worker before (the worker's "
                                    "stderr holds the stacks); not run again")
        running.parent.mkdir(exist_ok=True)
        running.touch()
    limit = limit_of(item)
    item.stash[_DEADLINE] = (None, None) if limit is None else (time.monotonic() + limit, limit)
    with _armed(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _armed(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    try:
        with _armed(item, teardown=True):
            return (yield)
    finally:
        running = _running_file(item)
        if running is not None:
            running.unlink(missing_ok=True)
