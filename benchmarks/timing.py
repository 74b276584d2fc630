"""Timing helper shared by the benchmark scripts.

Re-exports :func:`dicp_tpu.utils.timing.chained_rate`.
"""

from __future__ import annotations

from dicp_tpu.utils.timing import chained_rate

__all__ = ["chained_rate"]
