"""Every name a module of ``audax_torch`` exports in ``__all__`` exists, so
``from <module> import *`` works for each of them; and the log-mel body
table (``ops/fused_mel.py:BODIES``) names only counted kernels
(``ops.KERNELS``) and n_fft that ``csrc/log_mel_fft.cu`` instantiates."""

import importlib
import pkgutil
import re

import pytest

import audax_torch
from audax_torch.ops import KERNELS, direct_mel, fused_mel

from .csrc_constexpr import CSRC

MODULES = sorted(m.name for m in pkgutil.walk_packages(audax_torch.__path__,
                                                       "audax_torch."))


@pytest.mark.parametrize("name", MODULES)
def test_all_names_exist(name):
    mod = importlib.import_module(name)
    missing = [n for n in getattr(mod, "__all__", ()) if not hasattr(mod, n)]
    assert not missing, f"{name}.__all__ names missing attributes: {missing}"


def test_mel_body_table_matches_the_counters_and_the_source():
    src = (CSRC / "log_mel_fft.cu").read_text()
    built = {int(n) for n in re.findall(r"AUDAX_FFT\((\d+)\)", src)}
    assert built == set(direct_mel.FFT_SIZES)
    for sizes, fft, own in fused_mel.BODIES.values():
        assert fft in KERNELS and own in KERNELS
        assert set(sizes) <= built
    # K1's and K4's tiers on the FFT body count apart from every other
    # body, each beside its tier's plain version
    assert KERNELS["log_mel_overlap_fft"][1] is KERNELS["log_mel_overlap"][1]
    assert KERNELS["log_mel_packed_fft"][1] is KERNELS["log_mel_packed"][1]
    assert len({id(c) for c, _ in KERNELS.values()}) == len(KERNELS)
