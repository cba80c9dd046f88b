"""The port's test modules import ``free_tmp_path``, an autouse fixture that
deletes each passing test's ``tmp_path`` as soon as the test ends.

Their trainers write snapshots of a few hundred MB each (model, Adam
moments), and pytest keeps every test's directory of its last three
sessions: left in place, one run of the suite holds over ten GB of them at
its end. A failing test's directory stays for inspection, as pytest's
``tmp_path_retention_policy = "failed"`` would keep it.
"""

import shutil

import pytest


@pytest.fixture(autouse=True)
def free_tmp_path(request, tmp_path):
    failed = request.session.testsfailed
    yield
    if request.session.testsfailed == failed:
        shutil.rmtree(tmp_path, ignore_errors=True)
