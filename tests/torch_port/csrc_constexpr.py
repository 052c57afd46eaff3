"""The ``constexpr int`` functions of the port's CUDA sources, read from
their text and evaluated in Python, so that a test holds the formula the
kernel compiles (the shared memory of a tile, ...) and not a copy of it.

A function qualifies when its body is one ``return`` of integer
arithmetic, comparisons, ``||``/``&&`` and at most one ``?:``; constants
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
    return f"(({m[2]}) if ({m[1]}) else ({m[3]}))" if m else expr


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
