"""Structured span logging (JSON lines with task-local context).

Mirror of keyless-common/src/logging.rs:12-115: key-value context carried
through the request (the reference uses tokio task_locals; here a
contextvar so both threads and asyncio work), a JSON-line emitter, and an
RAII `Span` that stamps `milliseconds_elapsed` on exit.  The prover side
logs the same shape with `"native_code": "1"` (fullprover.cpp:67-78).
A `Span` also keeps its times on time.perf_counter and the calling
thread's CPU time, for the prove pipeline's per-request spans.

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
    """RAII timing span of the calling thread (logging.rs:53-100).

    It keeps `t0`, `t1` on time.perf_counter, the clock a torch.profiler
    trace can be tied to, and `cpu_ms`, the thread's CPU time over the
    span (time.thread_time): wall time less `cpu_ms` is what the thread
    waited. With `log`, it logs `<name> start` / `<name> end` with
    milliseconds_elapsed; at its end `into` (a list) receives `[name, t0,
    t1, cpu_ms]` and `observe` (a function) its seconds."""

    def __init__(self, name: str, log: bool = True, into: list | None = None, observe=None, **kv):
        self.name = name
        self.log = log
        self.into = into
        self.observe = observe
        self.kv = kv

    def __enter__(self):
        if self.log:
            log_event(f"{self.name} start", **self.kv)
        self.t0, self._cpu0 = time.perf_counter(), time.thread_time()
        return self

    def __exit__(self, exc_type, *a):
        self.t1 = time.perf_counter()
        self.cpu_ms = (time.thread_time() - self._cpu0) * 1e3
        if self.into is not None:
            self.into.append([self.name, self.t0, self.t1, self.cpu_ms])
        if self.observe is not None:
            self.observe(self.t1 - self.t0)
        if self.log:
            log_event(
                f"{self.name} end",
                level="ERROR" if exc_type else "INFO",
                milliseconds_elapsed=f"{(self.t1 - self.t0) * 1e3:.3f}",
                **self.kv,
            )
