"""Timestamped phase logging — printf_log equivalent (system.h:28-32), as
in ``c_raytracer_tpu.core.logging``.

Prints ``[elapsed] file:function:line: message`` on stderr, with elapsed
wall or CPU time since ``init`` (-p real|cpu, system.c:42-52).
"""

from __future__ import annotations

import inspect
import os
import sys
import time

_t0_wall = time.monotonic()
_t0_cpu = time.process_time()
_clock = "real"


def init(clock: str = "real") -> None:
    global _t0_wall, _t0_cpu, _clock
    _clock = clock
    _t0_wall = time.monotonic()
    _t0_cpu = time.process_time()


def elapsed() -> float:
    if _clock == "cpu":
        return time.process_time() - _t0_cpu
    return time.monotonic() - _t0_wall


def printf_log(msg: str, *args) -> None:
    frame = inspect.currentframe().f_back
    fname = os.path.basename(frame.f_code.co_filename)
    func = frame.f_code.co_name
    line = frame.f_lineno
    sys.stderr.write(
        f"[{elapsed():08.3f}] {fname}:{func}:{line}: {msg % args if args else msg}\n")
