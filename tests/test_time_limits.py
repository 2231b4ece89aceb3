"""The per-test time limit of tests/time_limits.py, as tier-1 runs it: pytest
in a subprocess, under pytest-xdist, on throwaway files with the repo's
pytest.ini, a 2 s `time_limit` marker and the hooks loaded by `-p`. A
sleeping test fails at its limit with the thread stacks in its report, its
fixture's tear-down, which starts past the limit, gets a grace and ends
cleanly, and the test after it passes; a test stuck where SIGALRM cannot reach it ends
its worker at the faulthandler backstop, and the run goes on. Also: each
test that the repository's root conftest.py marks by name exists."""
import ast
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

HERE = Path(__file__).resolve().parent

SLEEPS = '''
import time

import pytest


@pytest.fixture
def slow_to_tear_down():
    yield
    time.sleep(0.5)


@pytest.mark.time_limit(2)
def test_sleeps(slow_to_tear_down):
    time.sleep(60)


def test_after_the_sleeper():
    pass
'''

STUCK = '''
import signal
import time

import pytest


@pytest.mark.time_limit(2)
def test_stuck():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)


def test_after_the_stuck_one():
    pass
'''


def test_limit_fails_the_test_and_the_run_goes_on(tmp_path):
    shutil.copy(HERE.parent / "pytest.ini", tmp_path / "pytest.ini")
    (tmp_path / "test_sleeps.py").write_text(SLEEPS)
    (tmp_path / "test_stuck.py").write_text(STUCK)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--strict-markers", "-p", "no:cacheprovider",
         "-p", "time_limits", "-p", "xdist", "-n", "2", "--dist", "loadfile",
         f"--junitxml={tmp_path / 'out.xml'}", "test_sleeps.py", "test_stuck.py"],
        cwd=tmp_path, env={**{k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")},
                          "PYTHONPATH": str(HERE), "TMPDIR": str(tmp_path)},
        capture_output=True, text=True, timeout=60)
    log = out.stdout + out.stderr
    reports = {}
    for case in ET.parse(tmp_path / "out.xml").iter("testcase"):
        bad = case.find("failure") if case.find("failure") is not None else case.find("error")
        reports.setdefault(case.get("name"), []).append(
            "passed" if bad is None else bad.get("message", "") + (bad.text or ""))
    assert reports["test_after_the_sleeper"] == ["passed"], log
    assert reports["test_after_the_stuck_one"] == ["passed"], log
    [sleeper] = reports["test_sleeps"]
    assert "ran past its time limit of 2 s" in sleeper and "Thread MainThread" in sleeper
    assert "time.sleep(60)" in sleeper
    # the stuck test: its worker ended at the backstop (2 s + 1 s), with every
    # thread's stack on stderr; handed to the new worker, it fails at once
    crashed, again = reports["test_stuck"]
    assert "crashed" in crashed and "not run again" in again, log
    assert "Timeout (0:00:0" in log and "test_stuck.py\", line 11 in test_stuck" in log, log
    assert float(ET.parse(tmp_path / "out.xml").getroot().find("testsuite").get("time")) < 30


def test_root_conftest_marks_tests_that_exist(request):
    """SLOW and LIMITS of the root conftest.py name test functions of their
    files, so that no renamed test drops out of them unnoticed."""
    root = next(p for p in request.config.pluginmanager.get_plugins()
                if getattr(p, "__file__", None) == str(HERE.parent / "conftest.py"))
    for file, name in set(root.SLOW) | set(root.LIMITS):
        tree = ast.parse((HERE / file).read_text())
        assert name in {f.name for f in tree.body if isinstance(f, ast.FunctionDef)}, (file, name)
    assert all(0 < s <= 600 for s in root.LIMITS.values())
