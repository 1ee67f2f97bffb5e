"""One strict parser for every repro boolean env toggle.

``REPRO_KERNEL_INTERPRET``, ``REPRO_DEVICE_TIERING`` and
``REPRO_FLEET_LOCKSTEP`` all route through :func:`env_flag`: accepted
spellings are shared, and anything else raises so a typo'd CI line fails
loudly instead of silently testing the wrong path.
"""
from __future__ import annotations

import os
from typing import Optional

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def env_flag(var: str, default: Optional[bool] = None) -> Optional[bool]:
    """Strictly parse a boolean env var; ``default`` when unset."""
    env = os.environ.get(var)
    if env is None:
        return default
    if env.lower() in _TRUE:
        return True
    if env.lower() in _FALSE:
        return False
    raise ValueError(f"{var}={env!r}: expected one of {_TRUE + _FALSE}")
