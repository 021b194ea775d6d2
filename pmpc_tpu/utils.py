"""Small shared utilities: iteration table printing, shape helpers, dtype policy.

The ASCII iteration table prints the same columns/format as the reference
solver's progress log (role of ``pmpc/utils.py``), rendered by a column-spec
``TablePrinter``; ``atleast_nd`` / ``to_numpy_f64`` cover the same shape/dtype
canonicalization roles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class _Column:
    """One table column: a header plus a printf-style cell format."""

    name: str
    fmt: str

    @property
    def width(self) -> int:
        """Inner cell width: widest of header and representative rendered values."""
        probes: tuple
        if self.fmt.endswith("s"):
            probes = ("",)
        else:
            probes = (0, -1, 1)
        try:
            rendered = max(len(self.fmt % p) for p in probes)
        except TypeError as e:
            raise ValueError(f"Unrecognized print format [{self.fmt}]") from e
        return max(rendered, len(self.name)) + 2

    def cell(self, value) -> str:
        text = self.fmt % value
        pad = self.width - len(text)
        # numeric cells lean right: the spare space (odd widths) goes left
        return " " * (pad - pad // 2) + text + " " * (pad // 2)

    def head(self) -> str:
        return self.name.center(self.width)


class TablePrinter:
    """ASCII iteration-log table (``+---+`` rules, centered cells).

    Construct with column names and printf formats, then emit
    ``make_header()`` once, ``make_values(row)`` per iteration, and
    ``make_footer()`` at the end.
    """

    def __init__(self, names: Sequence[str], fmts: Optional[Sequence[str]] = None, prefix: str = ""):
        fmts = list(fmts) if fmts is not None else ["%9.4e"] * len(names)
        self.cols = [_Column(n, f) for n, f in zip(names, fmts)]
        self.prefix = prefix
        # validate formats eagerly (width raises on unsupported conversions)
        for c in self.cols:
            _ = c.width

    # backwards-compatible introspection
    @property
    def names(self):
        return [c.name for c in self.cols]

    @property
    def fmts(self):
        return [c.fmt for c in self.cols]

    @property
    def widths(self):
        return [c.width for c in self.cols]

    def _rule(self) -> str:
        return self.prefix + "+" + "+".join("-" * c.width for c in self.cols) + "+"

    def _row(self, cells: Sequence[str]) -> str:
        return self.prefix + "|" + "|".join(cells) + "|"

    def make_header(self) -> str:
        rule = self._rule()
        return "\n".join([rule, self._row([c.head() for c in self.cols]), rule])

    def make_footer(self) -> str:
        return self._rule()

    def make_values(self, vals: Sequence) -> str:
        if len(vals) != len(self.cols):
            raise ValueError(f"expected {len(self.cols)} values, got {len(vals)}")
        return self._row([c.cell(v) for c, v in zip(self.cols, vals)])

    def print_header(self) -> None:
        print(self.make_header())

    def print_footer(self) -> None:
        print(self.make_footer())

    def print_values(self, vals: Sequence) -> None:
        print(self.make_values(vals))


def atleast_nd(x, n: int):
    """Left-pad the shape of ``x`` with 1s until it has ``n`` dims (None passes through)."""
    if x is None:
        return None
    if not hasattr(x, "ndim"):
        x = np.asarray(x)
    missing = n - x.ndim
    if missing <= 0:
        return x
    return x[(None,) * missing]


def to_numpy_f64(x):
    """Convert to a float64 numpy array (python scalars pass through)."""
    if isinstance(x, (float, int)):
        return x
    arr = np.asarray(x)
    return arr if arr.dtype == np.float64 else arr.astype(np.float64)


import contextvars

_PREC_OVERRIDE: "contextvars.ContextVar" = contextvars.ContextVar(
    "pmpc_tpu_matmul_precision", default=None)


class hot_precision_scope:
    """Context manager: override the solver cores' traced matmul precision
    (consulted by every `with_matmul_precision` wrapper below at trace time;
    the env var PMPC_TPU_MATMUL_PRECISION still wins over everything).
    `chip_smoke.py` uses it to run the flagship under "high" for comparison."""

    def __init__(self, prec: Optional[str]):
        self.prec = prec
        self._tok = None

    def __enter__(self):
        self._tok = _PREC_OVERRIDE.set(self.prec)
        return self

    def __exit__(self, *exc):
        _PREC_OVERRIDE.reset(self._tok)
        return False


def with_matmul_precision(prec: str):
    """Decorator: trace the wrapped function under ``jax.default_matmul_precision``.

    Every solver core runs at 'highest' (full f32 products). On an NVIDIA
    GPU, 'high' and the default let f32 matmuls run in TF32 (~10 mantissa
    bits). Measured on an H100 (700 W) with the flagship batch (B=64, M=32,
    N=30, f32): 'highest' took 0.1045 s per call against 0.1178 s under
    'high', and kept the solution closer to the float64 one, so there is no
    speed to buy with TF32 at these block sizes (PERF.md). Override with env
    PMPC_TPU_MATMUL_PRECISION or `hot_precision_scope`.
    """
    import functools

    import jax

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            import os

            actual = os.environ.get(
                "PMPC_TPU_MATMUL_PRECISION",
                _PREC_OVERRIDE.get() or prec)
            with jax.default_matmul_precision(actual):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def default_dtype():
    """The framework's working dtype: float64 when JAX x64 is enabled, else float32."""
    import jax

    return np.float64 if jax.config.jax_enable_x64 else np.float32
