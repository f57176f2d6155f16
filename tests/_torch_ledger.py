"""An autouse fixture the port's test files import: the run ledger (on by
default, as in the JAX package) writes each test's records under its own
temporary directory, not into the working tree."""

import pytest


@pytest.fixture(autouse=True)
def _ledger_in_tmp(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_LEDGER_DIR", str(tmp_path_factory.mktemp("ledger")))
