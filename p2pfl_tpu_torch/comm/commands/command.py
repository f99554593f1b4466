"""Command ABC + dispatcher (the port's copy of
``p2pfl_tpu/comm/commands/command.py``; upstream p2pfl's
communication/commands/command.py:23-43)."""

from __future__ import annotations

import abc
import threading
from typing import Any, Dict, List, Optional


class Command(abc.ABC):
    """A named message handler."""

    @staticmethod
    @abc.abstractmethod
    def get_name() -> str: ...

    @abc.abstractmethod
    def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None: ...


class CommandDispatcher:
    """Thread-safe name -> Command registry used by transport servers
    (reference grpc_server.py:186-196 dispatch)."""

    def __init__(self) -> None:
        self._commands: Dict[str, Command] = {}
        self._lock = threading.Lock()

    def register(self, commands: List[Command]) -> None:
        with self._lock:
            for cmd in commands:
                self._commands[cmd.get_name()] = cmd

    def get(self, name: str) -> Optional[Command]:
        with self._lock:
            return self._commands.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._commands)

    def dispatch(self, name: str, source: str, round: int, *args: str, **kwargs: Any) -> None:
        cmd = self.get(name)
        if cmd is None:
            raise ValueError(f"unknown command {name!r} (known: {self.names()})")
        cmd.execute(source, round, *args, **kwargs)
