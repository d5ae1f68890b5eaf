"""Structured span logging (JSON lines with task-local context).

Mirror of keyless-common/src/logging.rs:12-115: key-value context carried
through the request (the reference uses tokio task_locals; here a
contextvar so both threads and asyncio work), a JSON-line emitter, and an
RAII `Span` that stamps `milliseconds_elapsed` on exit.  The prover side
logs the same shape with `"native_code": "1"` (fullprover.cpp:67-78).

A jax-free copy of keyless_zk_tpu/utils/logging.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import contextvars
import json
import sys
import time
from datetime import datetime, timezone

_context: contextvars.ContextVar[dict] = contextvars.ContextVar("log_ctx", default={})


def with_context(**kv):
    """Returns a context manager adding key-values to every log line inside."""

    class _Ctx:
        def __enter__(self):
            merged = {**_context.get(), **{k: str(v) for k, v in kv.items()}}
            self._token = _context.set(merged)
            return self

        def __exit__(self, *a):
            _context.reset(self._token)

    return _Ctx()


def log_event(message: str, level: str = "INFO", stream=None, **extra) -> None:
    line = {
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "level": level,
        "message": message,
        **_context.get(),
        **{k: str(v) for k, v in extra.items()},
    }
    print(json.dumps(line), file=stream or sys.stderr, flush=True)


class Span:
    """RAII timing span: logs `<name> start` / `<name> end` with
    milliseconds_elapsed (logging.rs:53-100)."""

    def __init__(self, name: str, **kv):
        self.name = name
        self.kv = kv

    def __enter__(self):
        self._t0 = time.monotonic()
        log_event(f"{self.name} start", **self.kv)
        return self

    def __exit__(self, exc_type, *a):
        ms = (time.monotonic() - self._t0) * 1e3
        log_event(
            f"{self.name} end",
            level="ERROR" if exc_type else "INFO",
            milliseconds_elapsed=f"{ms:.3f}",
            **self.kv,
        )
