"""Timing utilities.

Equivalent of `bm::chrono_taker` (src/bmtimer.h:40): a RAII wall-clock timer
accumulating named statistics — the reference's only profiling facility.
PyTorch returns from a call on the card before the card has done the work,
so the timer waits for the device of an optional tracked value before it
reads the clock, and ``profiler_trace`` wraps ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

statistics: dict[str, dict] = {}


def _wait(track):
    """Wait for the work queued on the device ``track`` lives on: a
    tensor, a container of the package (its ``device``) or a list or tuple
    of them.  Nothing is waited for on the CPU."""
    if isinstance(track, (list, tuple)):
        for t in track:
            _wait(t)
        return
    dev = torch.device(track.device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ChronoTaker:
    """with ChronoTaker("name"[, repeats][, track=...]): ... — accumulates
    into the module ``statistics`` map like the reference's
    chrono_taker::statistics.

    Without ``track`` the time is that of the host enqueueing the work,
    not of the card doing it: pass the result (or the container written)
    as ``track`` so that ``__exit__`` waits for its device first."""

    def __init__(self, name: str, repeats: int = 1, track=None):
        self.name = name
        self.repeats = repeats
        self.track = track

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.track is not None:
            _wait(self.track)
        dt = time.perf_counter() - self.t0
        st = statistics.setdefault(self.name, {"total_s": 0.0, "calls": 0,
                                               "repeats": 0})
        st["total_s"] += dt
        st["calls"] += 1
        st["repeats"] += self.repeats
        return False


def print_statistics(out=None):
    out = out or sys.stdout
    for name, st in sorted(statistics.items()):
        per = st["total_s"] / max(st["repeats"], 1)
        print(f"{name}: {st['total_s']*1e3:.2f} ms total, "
              f"{st['calls']} calls, {per*1e6:.1f} us/op", file=out)


def reset_statistics():
    statistics.clear()


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler wrapper for deep traces: records host and card
    activity (host only where there is no card) and writes one Chrome
    trace file (``*.pt.trace.json``) into ``logdir`` on exit.  Yields the
    profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
