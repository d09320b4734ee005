"""TCP streaming inference server: live audio in, event fragments out
(counterpart: seld_tpu/serve.py, `WindowBatcher`, `SELDServer` and
`stream_client`).

A long-lived process loads one predictor (a checkpoint, or an artifact of
seld_tpu_torch.export) onto the card and serves any number of sequential
or concurrent audio streams, each through its own StreamingSession: memory
bounded by a window per stream, and every stream's classes bit-equal to
the offline predict of the whole clip.

Protocol, byte for byte the JAX package's (stdlib on both sides;
`stream_client` is the reference client):

  client -> server, once:   one JSON line
      {"channels": C, "sample_rate": SR, "overlap": 0.0}
  client -> server, repeat: 4-byte LE uint32 byte-length N, then N bytes
      of float32 samples laid out (C, n) C-contiguous. N == 0 => flush.
  server -> client:         one JSON line per emitted fragment
      {"start_frame": k, "classes_b64": ..., "shape": [k_frames, G]}
      (classes are the int8 class grid, base64-raw), then after flush
      {"done": true, "total_samples": N} and the connection closes.
  errors:                   {"error": "..."} line, connection closes.

Concurrency: one thread per connection. Without batching a process-wide
lock serializes each push (features through K1 / K4, then the windows'
forwards), as in JAX. With `batch_streams` the connection threads compute
features concurrently and hand their windows to a `WindowBatcher`, whose
one thread packs the windows of every waiting stream into shared
fixed-shape forwards, each in the batch slot it takes offline, so every
stream stays bit-equal to offline. Every thread that runs the model does
so under torch.inference_mode(), which is thread-local.
"""

from __future__ import annotations

import base64
import contextlib
import json
import logging
import queue
import socket
import socketserver
import struct
import threading
import time
from collections import deque

import numpy as np
import torch

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<I")
MAX_CHUNK_BYTES = 64 * 1024 * 1024  # sanity bound: ~175 s of 4ch audio


class _WindowRequest:
    """One stream's window rows awaiting a forward; row j goes into batch
    slot (first_slot + j) % batch_windows."""

    __slots__ = ("fn", "rows", "first_slot", "out", "next_row", "done_rows", "event", "error")

    def __init__(self, fn, rows: torch.Tensor, first_slot: int):
        self.fn = fn
        self.rows = rows  # (k, win, C, F) on the predictor's device
        self.first_slot = first_slot
        self.out = None  # allocated on the first result (its dtype and shape)
        self.next_row = 0  # rows scheduled into batches so far
        self.done_rows = 0  # rows with results written back
        self.event = threading.Event()
        self.error: BaseException | None = None


class WindowBatcher:
    """Cross-stream continuous batching of the predictor's window forwards.

    The predictor runs every forward at one batch shape (`batch_windows`
    rows, SELDPredictor._batched). Without batching, N concurrent streams
    pay N forwards even when each brings one window. Installed as the
    predictor's `dispatch`, this batcher owns the forwards: stream threads
    enqueue their window rows and block; one worker thread packs rows from
    however many requests are pending when it is free (no added latency
    when idle, batches that fill under load) into one preallocated
    (batch_windows, win, C, F) device buffer, zeros in the slots no row
    takes, runs one forward, and scatters the result rows back.

    Each row goes into the batch slot its window takes in the offline
    predict, which its stream names: on the card a row's output depends on
    its slot (the same window in another slot differs in the last bits),
    though not on the rows beside it (PERF.md §7). So a batch packs only
    rows whose slots are free, in the order the requests came. Requests for
    different forwards (the class grid, or the representation overlapped
    streams average) never share a call: batches are cut at fn boundaries.

    `max_wait_s` > 0 holds a partial batch open that long for more streams
    to join (latency for throughput; 0 never delays a free worker).
    `batches_run` and `rows_run` count the forwards and the rows in them.
    """

    def __init__(self, predictor, max_wait_s: float = 0.0):
        self.p = predictor
        self.max_wait = float(max_wait_s)
        self.q: queue.Queue = queue.Queue()
        self._pending: deque[_WindowRequest] = deque()
        self._stop = False
        self._stop_lock = threading.Lock()  # orders __call__ against close()
        self._buf = None  # the packed batch, reused while the row shape holds
        self.batches_run = 0
        self.rows_run = 0
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def __call__(self, fn, windows: torch.Tensor, first_slot: int = 0) -> torch.Tensor:
        """The predictor's dispatch hook: fn over the windows, the first in
        batch slot `first_slot` and the rest in the slots after it (wrapping
        round); block until every row is computed."""
        req = _WindowRequest(fn, windows, first_slot % self.p.batch_windows)
        # under the lock: once close() has set _stop no request is enqueued,
        # so the worker's final drain sees every request ever submitted
        with self._stop_lock:
            if self._stop:
                raise RuntimeError("WindowBatcher is closed")
            self.q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.out

    def close(self) -> None:
        with self._stop_lock:
            self._stop = True
            self.q.put(None)  # wake the worker
        self.thread.join(timeout=10)

    # -- worker ----------------------------------------------------------------

    def _take(self, timeout) -> bool:
        """Move one queued request into _pending; False on timeout or stop."""
        try:
            r = self.q.get(timeout=timeout) if timeout else self.q.get_nowait()
        except queue.Empty:
            return False
        if r is None:
            return False
        self._pending.append(r)
        return True

    def _loop(self) -> None:
        try:
            with torch.inference_mode():
                while not self._stop:
                    if not self._pending and not self._take(timeout=0.25):
                        continue
                    # requests that arrived while a forward ran are still
                    # queued: drain them so that they join this batch
                    while self._take(timeout=0):
                        pass
                    # a request that failed in an earlier batch may still have
                    # rows unscheduled (its caller has the error): drop it
                    self._pending = deque(r for r in self._pending if r.error is None)
                    if not self._pending:
                        continue
                    self._run_batch(*self._select())
        finally:
            # close(), or an exception out of the loop: refuse new requests,
            # then fail every unfinished one, so that no caller blocks forever
            with self._stop_lock:
                self._stop = True
            self._drain_on_exit()

    def _select(self):
        """One batch: from the requests in order, up to the first with
        another fn than the first's, each request's next rows while their
        slots are free; waiting up to max_wait for more while slots are
        left. -> (fn, [(request, first row, rows)], rows in all)."""
        bw = self.p.batch_windows
        fn = self._pending[0].fn
        free = [True] * bw
        selected: dict[int, list] = {}
        deadline = time.monotonic() + self.max_wait
        while True:
            for r in self._pending:
                if r.fn != fn:  # equal, not identical: a bound method is new each access
                    break
                first = r.next_row
                while (r.next_row < r.rows.shape[0]
                       and free[(r.first_slot + r.next_row) % bw]):
                    free[(r.first_slot + r.next_row) % bw] = False
                    r.next_row += 1
                if r.next_row > first:
                    entry = selected.setdefault(id(r), [r, first, 0])
                    entry[2] += r.next_row - first
            cut = any(r.fn != fn for r in self._pending)
            if not any(free) or cut:
                break
            wait = deadline - time.monotonic()
            if wait <= 0 or not self._take(timeout=wait):
                break
        self._pending = deque(r for r in self._pending if r.next_row < r.rows.shape[0])
        chosen = [tuple(e) for e in selected.values()]
        return fn, chosen, bw - sum(free)

    def _drain_on_exit(self) -> None:
        err = RuntimeError("WindowBatcher closed before this request completed")
        while True:
            try:
                self._pending.append(self.q.get_nowait())
            except queue.Empty:
                break
        for r in self._pending:
            if r is not None:  # not close()'s sentinel
                r.error = r.error or err
                r.event.set()
        self._pending.clear()

    def _run_batch(self, fn, selected, total: int) -> None:
        # all of it under try: a failure while packing or scattering reaches
        # the waiting streams, and never ends the worker with callers blocked
        try:
            first = selected[0][0].rows
            bw = self.p.batch_windows
            if (self._buf is None or self._buf.shape[1:] != first.shape[1:]
                    or self._buf.dtype != first.dtype or self._buf.device != first.device):
                self._buf = first.new_zeros((bw, *first.shape[1:]))
            self._buf.zero_()
            slots = []
            for r, s, n in selected:
                slots.append(torch.remainder(torch.arange(r.first_slot + s,
                                                          r.first_slot + s + n), bw))
                self._buf.index_copy_(0, slots[-1].to(self._buf.device), r.rows[s:s + n])
            res = fn(self._buf)
            self.batches_run += 1
            self.rows_run += total
            for (r, s, n), where in zip(selected, slots):
                if r.out is None:
                    r.out = res.new_empty((r.rows.shape[0], *res.shape[1:]))
                r.out[s:s + n] = res.index_select(0, where.to(res.device))
                r.done_rows += n
                if r.done_rows == r.rows.shape[0]:
                    r.event.set()
        except BaseException as e:  # to every waiting stream
            for r, _, _ in selected:
                r.error = r.error or e
                r.event.set()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = rfile.read(n - len(buf))
        if not part:
            raise ConnectionError("client closed mid-frame")
        buf += part
    return buf


def _fragment_msg(start_frame: int, classes: np.ndarray) -> bytes:
    payload = np.ascontiguousarray(classes, np.int8)
    return (json.dumps({
        "start_frame": int(start_frame),
        "shape": list(payload.shape),
        "classes_b64": base64.b64encode(payload.tobytes()).decode(),
    }) + "\n").encode()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: SELDServer = self.server  # type: ignore[assignment]
        try:
            header = json.loads(self.rfile.readline().decode() or "{}")
            cfg = server.predictor.cfg
            channels = int(header.get("channels", cfg.model.n_channels))
            sr = int(header.get("sample_rate", cfg.features.sample_rate))
            overlap = float(header.get("overlap", 0.0))
            if sr != cfg.features.sample_rate:
                raise ValueError(f"sample rate {sr} != configured {cfg.features.sample_rate}")
            if channels != cfg.model.n_channels:
                raise ValueError(f"channels {channels} != configured {cfg.model.n_channels}")
            from seld_tpu_torch.stream import StreamingSession

            session = StreamingSession(server.predictor, overlap=overlap)
            total = 0
            with torch.inference_mode():
                while True:
                    (n,) = _LEN.unpack(_read_exact(self.rfile, _LEN.size))
                    if n == 0:
                        break
                    if n > MAX_CHUNK_BYTES or n % (4 * channels) != 0:
                        raise ValueError(f"bad chunk byte-length {n}")
                    raw = _read_exact(self.rfile, n)
                    chunk = np.frombuffer(raw, np.float32).reshape(channels, -1)
                    total += chunk.shape[1]
                    with server.device_lock:
                        frags = session.push(chunk)
                    for start, classes in frags:
                        self.wfile.write(_fragment_msg(start, classes))
                    self.wfile.flush()
                with server.device_lock:
                    frags = session.flush()
            for start, classes in frags:
                self.wfile.write(_fragment_msg(start, classes))
            done = {"done": True, "total_samples": total}
            self.wfile.write((json.dumps(done) + "\n").encode())
            self.wfile.flush()
            # only completed streams count toward max_streams: a port scan or
            # a failed handshake must not shut the server down
            server.stream_finished()
        except (ConnectionError, BrokenPipeError):
            pass  # the client went away; nothing to tell it
        except Exception as e:  # protocol and shape errors: tell the client
            logger.warning("serve: request failed: %s", e)
            try:
                self.wfile.write((json.dumps({"error": str(e)}) + "\n").encode())
                self.wfile.flush()
            except OSError:
                pass


class SELDServer(socketserver.ThreadingTCPServer):
    """serve_forever() on a bound port, one thread per connection.

    `max_streams` > 0 shuts the server down after that many streams have
    completed: the clean exit for benchmarks and scripts. `batch_streams`
    installs a WindowBatcher as the predictor's dispatch for the server's
    lifetime (server_close removes it)."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 0,
                 max_streams: int = 0, batch_streams: bool = False,
                 batch_wait_s: float = 0.0):
        self.predictor = predictor
        self.max_streams = max_streams
        self._streams_done = 0
        self._count_lock = threading.Lock()
        self.batcher = None
        # with batching the batcher owns the forwards, so the connection
        # threads must not serialize: they submit concurrently
        self.device_lock = contextlib.nullcontext() if batch_streams else threading.Lock()
        super().__init__((host, port), _Handler)
        if batch_streams:
            # only after the bind succeeded: a failed bind leaves no server
            # to close, and must not leave a batcher on the predictor
            self.batcher = WindowBatcher(predictor, max_wait_s=batch_wait_s)
            predictor.dispatch = self.batcher

    def server_close(self):
        if self.batcher is not None:
            self.predictor.dispatch = None
            self.batcher.close()
        super().server_close()

    def stream_finished(self) -> None:
        with self._count_lock:
            self._streams_done += 1
            if self.max_streams and self._streams_done >= self.max_streams:
                threading.Thread(target=self.shutdown, daemon=True).start()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def stream_client(host: str, port: int, chunks, overlap: float = 0.0,
                  channels: int | None = None, sample_rate: int | None = None,
                  timeout: float = 600.0):
    """Reference client: send `chunks` ((C, n) float32 arrays), return
    (classes (T, G) int8, info dict). Raises RuntimeError on a server
    error line, TimeoutError when no answer comes within `timeout` s."""
    chunks = list(chunks)
    if channels is None:
        channels = chunks[0].shape[0] if chunks else 4
    frags = []
    info: dict = {}
    err: list = []
    with socket.create_connection((host, port), timeout=timeout) as sock:
        wf = sock.makefile("wb")
        rf = sock.makefile("rb")

        # read while sending: the server emits fragments as chunks arrive,
        # and leaving them in the socket buffers can deadlock long streams
        def reader():
            try:
                while True:
                    line = rf.readline()
                    if not line:
                        raise ConnectionError("server closed without done")
                    msg = json.loads(line.decode())
                    if "error" in msg:
                        raise RuntimeError(f"server error: {msg['error']}")
                    if msg.get("done"):
                        info.update(msg)
                        return
                    classes = np.frombuffer(base64.b64decode(msg["classes_b64"]),
                                            np.int8).reshape(msg["shape"])
                    frags.append((msg["start_frame"], classes))
            except Exception as e:  # raised to the caller below
                err.append(e)

        t = threading.Thread(target=reader)
        t.start()
        header = {"channels": channels, "overlap": overlap}
        if sample_rate is not None:
            header["sample_rate"] = sample_rate
        try:
            wf.write((json.dumps(header) + "\n").encode())
            wf.flush()
            for chunk in chunks:
                data = np.ascontiguousarray(chunk, np.float32).tobytes()
                wf.write(_LEN.pack(len(data)))
                wf.write(data)
                wf.flush()
            wf.write(_LEN.pack(0))
            wf.flush()
        except OSError:
            pass  # the server closed early: the reader holds the reason
        t.join(timeout=timeout)
        if err:
            raise err[0]
        if t.is_alive():
            raise TimeoutError(f"no done message within {timeout} s")

    frags.sort(key=lambda kv: kv[0])
    if frags:
        classes = np.concatenate([c for _, c in frags], axis=0)
    else:
        classes = np.zeros((0, 0), np.int8)
    return classes, info
