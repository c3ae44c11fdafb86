"""The per-test time limit (``time_limit.TimeLimit``, which
the root ``conftest.py`` registers) in a run of its own under xdist with a 2 s
limit: a test stuck inside a C call fails once, with the limit's message
and every thread's stack, is not run again, and the test after it in the
same file still runs."""
import os
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

CONFTEST = f'''
import sys

sys.path.insert(0, {str(Path(__file__).parent)!r})
from time_limit import TimeLimit


def pytest_configure(config):
    config.pluginmanager.register(TimeLimit(2), "time_limit")
'''
TESTS = '''
import ctypes
from pathlib import Path


def test_stuck():
    with open(Path(__file__).with_name("runs"), "a") as runs:
        runs.write("run\\n")
    ctypes.CDLL(None).sleep(600)


def test_after_it():
    pass
'''


def test_a_stuck_test_fails_once_and_the_run_goes_on(tmp_path):
    (tmp_path / "conftest.py").write_text(CONFTEST)
    (tmp_path / "test_inner.py").write_text(TESTS)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST")}
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "2", "--dist", "loadfile",
         "--junitxml", "inner.xml", "test_inner.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 1, run.stdout + run.stderr
    assert (tmp_path / "runs").read_text() == "run\n"
    cases = {}
    for case in ET.parse(tmp_path / "inner.xml").iter("testcase"):
        cases.setdefault(case.get("name"), []).append(
            [(child.tag, child.get("message", "") + (child.text or ""))
             for child in case])
    assert sorted(cases) == ["test_after_it", "test_stuck"]
    assert cases["test_after_it"] == [[]]
    (outcome,), = cases["test_stuck"]
    assert outcome[0] == "error"        # a worker's crash has no phase
    assert "ran past its time limit of 2 s" in outcome[1]
    assert "most recent call first" in outcome[1]
    assert "in test_stuck" in outcome[1]
