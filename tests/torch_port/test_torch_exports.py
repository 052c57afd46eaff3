"""Every name a module of ``audax_torch`` exports in ``__all__`` exists, so
``from <module> import *`` works for each of them."""

import importlib
import pkgutil

import pytest

import audax_torch

MODULES = sorted(m.name for m in pkgutil.walk_packages(audax_torch.__path__,
                                                       "audax_torch."))


@pytest.mark.parametrize("name", MODULES)
def test_all_names_exist(name):
    mod = importlib.import_module(name)
    missing = [n for n in getattr(mod, "__all__", ()) if not hasattr(mod, n)]
    assert not missing, f"{name}.__all__ names missing attributes: {missing}"
