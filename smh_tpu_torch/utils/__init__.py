"""Utilities: per-stage timing, debug image dumps, line plotting, ring logs."""

from .timeshares import Timeshares, timeshare  # noqa: F401
from .plot import plot_line  # noqa: F401
