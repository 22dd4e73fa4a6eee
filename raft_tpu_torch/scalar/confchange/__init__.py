"""Joint-consensus membership changes (reference: src/confchange.rs + subdir)."""

from __future__ import annotations

from .changer import Changer, MapChange, MapChangeType, joint
from .restore import restore, to_conf_change_single

__all__ = [
    "Changer",
    "MapChange",
    "MapChangeType",
    "joint",
    "restore",
    "to_conf_change_single",
]
