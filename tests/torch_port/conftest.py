"""Harness for the PyTorch port's CPU tests (``tests/torch_port``).

The root ``tests/conftest.py`` marks every module outside its
``FAST_MODULES`` as ``slow``, and the tier-1 run deselects ``slow``. These
tests are small host-side parity checks, so this hookwrapper runs around
the root hook and pytest's own deselection: afterwards it strips ``slow``
from the port's items, marks them ``fast``, and applies pytest's ``-k`` and
``-m`` selection to them again, so ``-m 'not slow'`` runs them and
``-m slow`` does not.

Each test process runs PyTorch with one thread, so the parallel workers of
a ``-n`` run do not contend for the host's cores.
"""

from pathlib import Path

import pytest
import torch
from _pytest.mark import deselect_by_keyword, deselect_by_mark

_HERE = Path(__file__).resolve().parent

torch.set_num_threads(1)


@pytest.hookimpl(hookwrapper=True)
def pytest_collection_modifyitems(session, config, items):
    ours = [it for it in items if _HERE in Path(str(it.fspath)).parents]
    yield
    mine = {id(it) for it in ours}
    items[:] = [it for it in items if id(it) not in mine]
    for it in ours:
        it.own_markers[:] = [m for m in it.own_markers if m.name != "slow"]
        it.add_marker(pytest.mark.fast)
    deselect_by_keyword(ours, config)        # pytest's own -k and -m rules
    deselect_by_mark(ours, config)
    items.extend(ours)
    # the first pass reported every port test it dropped as deselected;
    # keep the terminal summary's count to the tests finally left out
    reporter = config.pluginmanager.get_plugin("terminalreporter")
    if reporter is not None:
        final, seen, left_out = {id(it) for it in items}, set(), []
        for it in reporter.stats.get("deselected", []):
            if id(it) not in final and id(it) not in seen:
                seen.add(id(it))
                left_out.append(it)
        reporter.stats["deselected"] = left_out
