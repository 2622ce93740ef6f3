"""Server-sent-events log hub (flask_sse replacement, stdlib only).

The reference pushes training-log lines to the browser through Redis-backed
flask_sse (`utils/utils.py:278-291`,
`app.py:22 /stream` blueprint).  Here a small in-process hub fans messages
out to any number of SSE subscriber queues; the WSGI app streams them with
`text/event-stream` responses — no Redis, no Flask.
"""
from __future__ import annotations

import json
import queue
import threading
from typing import Iterator


class LogHub:
    def __init__(self, maxsize: int = 1000):
        self._subs: list[queue.Queue] = []
        self._lock = threading.Lock()
        self.maxsize = maxsize

    def subscribe(self) -> "queue.Queue[str]":
        q: queue.Queue = queue.Queue(self.maxsize)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def publish(self, data: dict, type_: str = "log") -> None:
        payload = f"event: {type_}\ndata: {json.dumps(data)}\n\n"
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(payload)
            except queue.Full:
                pass

    def stream(self, q: queue.Queue, timeout: float = 15.0) -> Iterator[bytes]:
        """Yield SSE frames; emits keepalive comments on idle.

        Unsubscribes `q` when the consumer stops iterating (the WSGI server
        close()s the generator on client disconnect, delivering GeneratorExit
        here), so disconnected clients don't leak queues in `_subs`.
        """
        try:
            while True:
                try:
                    yield q.get(timeout=timeout).encode()
                except queue.Empty:
                    yield b": keepalive\n\n"
        finally:
            self.unsubscribe(q)


HUB = LogHub()


def log(log_queue_obj, message: str, *args) -> None:
    """Format + enqueue + SSE-publish (parity:
    `utils/utils.py:278-291`)."""
    try:
        formatted = message % args if args else message
        if hasattr(log_queue_obj, "put"):
            log_queue_obj.put(formatted)
        HUB.publish({"message": formatted}, type_="log")
    except Exception as e:  # noqa: BLE001
        print(f"Error in log function: {e}")
