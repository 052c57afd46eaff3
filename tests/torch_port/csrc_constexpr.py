"""The ``constexpr int`` functions of the port's CUDA sources, read from
their text and evaluated in Python, so that a test holds the formula the
kernel compiles (the shared memory of a tile, ...) and not a copy of it.

``instantiated`` reads the (head_dim, block_q, block_k) sets that an
instantiation macro lists, as one ``-D`` build of a two-library source
sees them.

A function qualifies when its body is one ``return`` of integer
arithmetic, comparisons, ``||``/``&&`` and ``?:`` (nested only in the
last operand, ``a ? b : c ? d : e``); constants
are ``constexpr int NAME = <expression>;`` lines at namespace level (no
indent), each an expression of the integers and constants before it. The
source's quoted ``#include`` headers are read first.
"""

import re
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[2] / "audax_torch" / "csrc"

_FUNCTION = re.compile(r"constexpr int (\w+)\(([^)]*)\)\s*\{\s*return ([^;]+);"
                       r"\s*\}")
_CONSTANT = re.compile(r"^constexpr int (\w+) = ([^;]+);", re.M)


def _python(expr: str) -> str:
    expr = " ".join(expr.split())       # a return may span lines
    expr = expr.replace("||", " or ").replace("&&", " and ")
    expr = re.sub(r"(?<![/])/(?![/])", "//", expr)
    m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", expr)
    return (f"(({m[2]}) if ({m[1]}) else ({_python(m[3])}))" if m
            else expr)


def constexpr_function(source: str, name: str) -> Callable[..., int]:
    """``name`` of ``csrc/<source>`` (or a header it includes) as a Python
    function of the same integer arguments."""
    main = (CSRC / source).read_text()
    text = "\n".join([*((CSRC / h).read_text() for h in
                        re.findall(r'#include "([\w.]+)"', main)), main])
    ns = {}
    for k, expr in _CONSTANT.findall(text):
        ns[k] = int(eval(_python(expr), ns))
    for fn, params, expr in _FUNCTION.findall(text):
        args = ", ".join(p.split()[-1] for p in params.split(","))
        ns[fn] = eval(f"lambda {args}: {_python(expr)}", ns)
    return ns[name]


def instantiated(source: str, macro: str, kernel: str) -> set:
    """``(head_dim, block_q, block_k)`` that ``macro`` instantiates in the
    library of ``kernel`` built from ``csrc/<source>`` ("dq":
    ``-DAUDAX_FLASH_BWD_DQ``, "dkv": ``-DAUDAX_FLASH_BWD_DKV``): the lines
    of ``#if defined(AUDAX_FLASH_BWD_DKV)`` / ``#else`` / ``#endif`` that
    build keeps."""
    keep, lines = True, []
    for line in (CSRC / source).read_text().splitlines():
        word = line.strip()
        if word.startswith("#if defined(AUDAX_FLASH_BWD_DKV)"):
            keep = kernel == "dkv"
        elif word == "#else":
            keep = not keep
        elif word.startswith("#endif"):
            keep = True
        elif keep:
            lines.append(line)
    return {tuple(map(int, m)) for m in re.findall(
        rf"{macro}\((\d+), (\d+), (\d+)\)", "\n".join(lines))}
