"""Shared executor backing the promise-style API variants.

The reference exposes async variants next to every `*_sync` method
(`decode_audio_data` base.rs:68-103, `OfflineAudioContext::start_rendering`
offline.rs:198-230, suspend/resume futures offline.rs:241-251 and
online.rs:523-784).  The Python translation returns
`concurrent.futures.Future`s from a small shared thread pool: call
`.result()` to block, or `asyncio.wrap_future(...)` to await from an
event loop.  Rendering releases the GIL inside PyTorch's operators and
while the host waits on the card, so the threads give real concurrency.
Ported from `webaudio_tpu/futures.py` (framework-free, copied).
"""

from __future__ import annotations

import atexit
import concurrent.futures
import threading

_lock = threading.Lock()
_executor: concurrent.futures.ThreadPoolExecutor | None = None


def get_executor() -> concurrent.futures.ThreadPoolExecutor:
    global _executor
    with _lock:
        if _executor is None:
            _executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="webaudio-async")
            atexit.register(_executor.shutdown, wait=False)
        return _executor


def submit(fn, *args, **kw) -> concurrent.futures.Future:
    return get_executor().submit(fn, *args, **kw)


def submit_dedicated(fn, *args, **kw) -> concurrent.futures.Future:
    """Run `fn` on its own daemon thread rather than the shared pool.

    For tasks that can block indefinitely waiting on user action — an
    offline render parked inside `suspend(t)` holds its thread on
    `gate.wait()` until `resume()`; on the shared 4-worker pool a handful
    of concurrently suspended renders would starve every other future
    (including ones whose completion is needed to trigger the resume)."""
    f: concurrent.futures.Future = concurrent.futures.Future()

    def run():
        if not f.set_running_or_notify_cancel():
            return
        try:
            f.set_result(fn(*args, **kw))
        except BaseException as exc:  # noqa: BLE001 - mirrored into the future
            f.set_exception(exc)

    threading.Thread(target=run, daemon=True,
                     name="webaudio-render").start()
    return f


def completed(value) -> concurrent.futures.Future:
    f: concurrent.futures.Future = concurrent.futures.Future()
    f.set_result(value)
    return f
