"""The node under test: one port ``Command`` on its own asyncio loop thread."""

from __future__ import annotations

import asyncio
import threading
import time


class Node:
    """Runs ``cmd.run`` on a loop thread of its own until :meth:`close`."""

    def __init__(self, cmd, start_timeout_s: float = 300.0):
        self.cmd = cmd
        self.loop = asyncio.new_event_loop()
        self.stop_ev = None
        self.error = None
        self.thread = threading.Thread(target=self._run, name="portbench-node", daemon=True)
        self.thread.start()
        deadline = time.monotonic() + start_timeout_s
        while not cmd.started.is_set():
            if self.error is not None:
                raise self.error
            if not self.thread.is_alive() or time.monotonic() > deadline:
                raise RuntimeError("the node did not start serving")
            time.sleep(0.01)

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)

        async def main():
            self.stop_ev = asyncio.Event()
            await self.cmd.run(self.stop_ev)

        try:
            self.loop.run_until_complete(main())
        except BaseException as exc:  # handed to the harness's thread
            self.error = exc
        finally:
            self.loop.close()

    def close(self, timeout_s: float = 60.0) -> None:
        if self.thread.is_alive():
            self.loop.call_soon_threadsafe(self.stop_ev.set)
            self.thread.join(timeout_s)
        if self.thread.is_alive():
            raise RuntimeError("the node did not shut down")
        if self.error is not None:
            raise self.error
