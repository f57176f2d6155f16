"""One result for the whole test run, whichever xdist worker needs it
first: ``run_once(tmp_path_factory, name, fn)`` calls ``fn()`` once (a
rank group's start-up and its jobs, a compiled reference model's steps),
pickles the result under the run's shared temporary root behind a file
lock, and every later caller, in any worker, reads it back. Without
xdist the result is kept in the process."""

import fcntl
import os
import pickle

_LOCAL: dict = {}


def run_once(tmp_path_factory, name: str, fn):
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        if name not in _LOCAL:
            _LOCAL[name] = fn()
        return _LOCAL[name]
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}_{uid}.pkl"
    with open(root / f"{name}_{uid}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = fn()
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
