"""Thread-safe singleton metaclass (reference: p2pfl/utils/singleton.py).

The port's copy of ``p2pfl_tpu/utils/singleton.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class SingletonMeta(type):
    """Metaclass giving each class a single, lazily-created instance."""

    _instances: Dict[type, Any] = {}
    _lock = threading.Lock()

    def __call__(cls, *args: Any, **kwargs: Any) -> Any:
        if cls not in cls._instances:
            with SingletonMeta._lock:
                if cls not in cls._instances:
                    cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]

    @classmethod
    def reset(mcs, cls: type) -> None:
        """Drop the cached instance (tests)."""
        with mcs._lock:
            mcs._instances.pop(cls, None)
