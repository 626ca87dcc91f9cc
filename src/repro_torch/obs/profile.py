"""Opt-in ``torch.profiler`` hooks for the serving stack (port of
src/repro/obs/profile.py, on ``torch.profiler`` in place of
``jax.profiler``; DESIGN.md §15).

The tracer (obs/trace.py) attributes *host-observed* wall time; when a
device stage itself needs opening up (which kernel, how long on the
card), the PyTorch profiler is the tool.  This module is the thin,
failure-proof seam between the two:

* ``span(name)`` — THE way the port names a range: while a profiler is
  capturing, ``torch.profiler.record_function(name)`` (a
  ``user_annotation`` range on the same clock as the device events);
  otherwise one shared ``contextlib.nullcontext()``, so an untraced call
  pays a function call and a flag read.  The engine's ``geo.*`` phase
  spans (``GeoEngine.assign`` down to ``resolve_candidates``' PIP) use
  it.
* ``device_annotation(name, device=None)`` — ``span(name)`` plus
  ``torch.cuda.nvtx.range`` when ``device`` is a CUDA device, so
  device-stage assigns show up as named ranges.  ``GeoServer`` applies
  it around every padded assign when ``ServeConfig.trace_device=True``.
* ``start_profile(logdir)`` / ``stop_profile()`` — the capture pair: a
  ``torch.profiler.profile`` over the CPU and, when there is a card,
  CUDA activity; ``stop_profile`` writes the Chrome trace to
  ``<logdir>/trace.json``.  Exposed on ``GeoServer`` so a load run can
  bracket a trial with a device trace capture.

Like the JAX profiler, the capture is one per process, so its session
lives here.  Every entry point degrades to a no-op (with a one-line
warning once) if the profiler is unavailable or refuses —
observability must never be able to take the serve path down.
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

__all__ = ["span", "device_annotation", "start_profile", "stop_profile",
           "profiler_available", "TRACE_FILE"]

TRACE_FILE = "trace.json"      # Chrome trace written under the logdir
_OFF = contextlib.nullcontext()   # what ``span`` returns when no profiler runs

_warned = set()
_warn_lock = threading.Lock()


def _warn_once(key: str, msg: str) -> None:
    with _warn_lock:
        if key in _warned:
            return
        _warned.add(key)
    print(f"obs.profile: {msg}")


class _Session:
    """The process's one active capture (None = no capture)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.prof = None                  # guarded-by: _lock
        self.logdir = None                # guarded-by: _lock

    def start(self, logdir: str) -> bool:
        with self._lock:
            if self.prof is not None:
                _warn_once("active", "a capture is already active")
                return False
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            except Exception as e:     # boundary: never fail the caller
                _warn_once("start", f"profiler start failed ({e}) — "
                                    f"profiling off")
                return False
            self.prof, self.logdir = prof, logdir
            return True

    def stop(self) -> bool:
        with self._lock:
            prof, logdir = self.prof, self.logdir
            self.prof = self.logdir = None
        if prof is None:
            return False
        try:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
        except Exception as e:         # boundary: never fail the caller
            _warn_once("stop", f"profiler stop failed ({e})")
            return False
        return True


_SESSION = _Session()


def profiler_available() -> bool:
    return hasattr(torch.profiler, "record_function")


def span(name: str):
    """A named range while a profiler captures (``torch.profiler`` or
    ``start_profile``), else the shared null context: no allocation and
    no profiler call when nothing records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def device_annotation(name: str, device=None):
    """``span(name)`` (and an NVTX range on a CUDA ``device``) around a
    device call; no-op when the profiler refuses."""
    with contextlib.ExitStack() as stack:
        try:
            stack.enter_context(span(name))
            if device is not None and torch.device(device).type == "cuda":
                stack.enter_context(torch.cuda.nvtx.range(name))
        except Exception as e:         # boundary: never fail the caller
            _warn_once("annotation", f"annotation unavailable ({e}) — "
                                     f"device annotations off")
        yield


def start_profile(logdir: str) -> bool:
    """Begin a trace capture that ``stop_profile`` writes under
    ``logdir``; True if it started.  Refusals (already active, profiler
    failure) warn once and return False instead of raising."""
    return _SESSION.start(logdir)


def stop_profile() -> bool:
    """End the active capture and write ``<logdir>/trace.json``; True if
    one was stopped and written."""
    return _SESSION.stop()
