"""Console formatting (counterpart of baselines_tpu/core/console_util.py, after
baselines/common/console_util.py): aligned table cells and rows, ANSI colours and a
nested stopwatch."""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np

# the ANSI SGR foreground codes 30..38, in their standard order
_ANSI_FG = {name: 30 + i for i, name in enumerate(
    "gray red green yellow blue magenta cyan white crimson".split())}


def fmt_item(value, width):
    """One table cell, right-aligned to ``width``; a float in scientific notation
    outside [1e-4, 1e4] (console_util.py:18-30)."""
    if isinstance(value, np.ndarray):
        assert value.ndim == 0, "only scalars belong in a table cell"
        value = value.item()
    if isinstance(value, float):
        mag = abs(value)
        text = f"{value:7.2e}" if 0 < mag and not (1e-4 <= mag <= 1e4) else f"{value:7.5f}"
    else:
        text = str(value)
    return text.rjust(width)


def fmt_row(width, row, header=False):
    """The cells joined by ' | ', a header underlined."""
    line = " | ".join(fmt_item(cell, width) for cell in row)
    return line + "\n" + "-" * len(line) if header else line


def colorize(string, color="green", bold=False, highlight=False):
    """``string`` in ANSI SGR codes: the colour, as the background with ``highlight``,
    and bold."""
    codes = [str(_ANSI_FG[color] + (10 if highlight else 0))]
    if bold:
        codes.append("1")
    return f"\x1b[{';'.join(codes)}m{string}\x1b[0m"


_timed_depth = 0


@contextmanager
def timed(msg):
    """Print ``msg``, run the block, print its time; nested blocks indent
    (console_util.py:73-80)."""
    global _timed_depth
    indent = "\t" * _timed_depth
    print(colorize(f"{indent}=: {msg}", color="magenta"))
    _timed_depth += 1
    start = time.time()
    try:
        yield
    finally:
        _timed_depth -= 1
        print(colorize(f"{indent}done in {time.time() - start:.3f} seconds", color="magenta"))
