"""Memory budgets read from the device.

Each budget is a fixed share of the memory the first device gives this
process (``memory_stats()["bytes_limit"]``). Where the backend reports no
memory statistics (the CPU backend), the budget keeps its fixed default.
"""

from __future__ import annotations

import jax

# The shares were set as fixed byte counts against a device whose process
# limit was 15.75e9 bytes; each share keeps that fraction of the device.
_REFERENCE_LIMIT = 15.75e9
DDM_FACTOR_DEFAULT = 5.0e9
FUSED_FACTOR_DEFAULT = float(512 << 20)


def device_bytes_limit() -> int | None:
    """Bytes the first device gives this process, or None if unknown."""
    stats = jax.devices()[0].memory_stats()
    if not stats or not stats.get("bytes_limit"):
        return None
    return int(stats["bytes_limit"])


def device_share(default_bytes: float) -> float:
    """``default_bytes`` scaled from the reference limit to this device."""
    limit = device_bytes_limit()
    if limit is None:
        return float(default_bytes)
    return float(default_bytes) / _REFERENCE_LIMIT * limit


def ddm_factor_budget_bytes() -> float:
    """Budget for the stored Schwarz leaf factors of all levels."""
    return device_share(DDM_FACTOR_DEFAULT)


def fused_factor_budget_bytes() -> float:
    """Largest factor total for which the whole FGMRES cycle is traced
    into one device program (see ``solver.fused.FusedSystem``)."""
    return device_share(FUSED_FACTOR_DEFAULT)
