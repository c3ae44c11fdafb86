"""A per-test time limit for xdist runs (registered by the repo's root
``conftest.py``)."""
import faulthandler
import hashlib
import shutil
import tempfile
from pathlib import Path

import pytest


class TimeLimit:
    """Ends the xdist worker whose test runs past `seconds`, so that the
    run goes on without it; the test fails once and is not run again.

    A hang can sit inside a C call (XLA's CPU runtime), where no Python
    signal handler runs, so faulthandler's watchdog thread dumps every
    thread's stack into a file named after the test and exits the worker.
    The controller reports the test as failed with that dump. xdist hands
    the dead worker's unfinished tests to another worker, which skips this
    one because its dump is still there. A run without xdist has no limit:
    exiting its process would end the run. Nor has a run with pytest's
    `faulthandler_timeout`: a process has one faulthandler watchdog."""

    def __init__(self, seconds):
        self.seconds = seconds
        self.dir = None           # the controller's: the dumps of this run
        self.left_over = False    # a worker's: this test's dump was there

    @staticmethod
    def _dump(directory, nodeid):
        return Path(directory, hashlib.sha1(nodeid.encode()).hexdigest())

    @pytest.hookimpl(optionalhook=True)
    def pytest_configure_node(self, node):
        self.dir = self.dir or tempfile.mkdtemp(prefix="pytest-time-limit-")
        node.workerinput["time_limit_dir"] = self.dir

    @pytest.hookimpl(optionalhook=True)
    def pytest_handlecrashitem(self, crashitem, report, sched):
        path = self._dump(self.dir, crashitem)
        if path.exists() and path.stat().st_size:
            report.longrepr = (f"ran past its time limit of {self.seconds} s;"
                               f" every thread's stack:\n{path.read_text()}")

    def pytest_unconfigure(self, config):
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)

    @staticmethod
    def _worker_dump(item):
        directory = getattr(item.config, "workerinput", {}).get(
            "time_limit_dir")
        if directory and not float(
                item.config.getini("faulthandler_timeout") or 0):
            return TimeLimit._dump(directory, item.nodeid)
        return None

    @pytest.hookimpl(wrapper=True, specname="pytest_runtest_protocol")
    def pytest_runtest_protocol_limited(self, item, nextitem):
        path = self._worker_dump(item)
        self.left_over = bool(path and path.exists())
        if not path or self.left_over:
            return (yield)
        with open(path, "w") as dump:
            faulthandler.dump_traceback_later(self.seconds, exit=True,
                                              file=dump)
            try:
                return (yield)
            finally:
                faulthandler.cancel_dump_traceback_later()
                path.unlink()

    @pytest.hookimpl(tryfirst=True)
    def pytest_runtest_protocol(self, item, nextitem):
        if self.left_over:
            # A worker ended in this test. The test comes first in its
            # file's work unit, after the worker's previous file was torn
            # down, so skipping it leaves nothing set up.
            return True
        return None
