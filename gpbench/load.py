"""What every load generator shares: the benchmark's spans, the seeded
streams, the sample of groups the check replays, and the device sync.

A load generator is a file ``gpbench/loads/<load>.py`` whose class
``Load`` a traffic mix names by its ``load`` key; the harness finds it by
that name.  A traffic mix (``traffic/<mix>.json``) gives the load's
parameters, among them ``steps_per_dispatch`` (N, the consensus steps a
call of the step face runs; 1 where the mix names none); a configuration
(``configs/<config>.json``) gives the deployment's sizes.  Everything a
run offers is drawn from ``--seed``.

A ``Load`` is built as ``Load(config, traffic, seed, system, spans)`` and
offers:

* ``G``: the groups, over which ``device_bytes_per_group`` is taken;
* ``setup()`` and ``setup_parts`` (seconds by part); ``chunk()``, one
  chunk of the window, ending in a device sync;
* ``open_window(t)``, ``close_window(t)``, ``finish()`` (the program's
  state read back at the sample, then freed);
* ``window_metrics(window_s)``: the end-to-end metrics it measures and
  the requests or steps attempted;
* ``check(reference)``: ``{"checks": {name: (value, limit)}, "failed",
  "steps"}``;
* ``trace_context(chunks)``: what the per-layer readers need of the
  traced ``chunks`` (the face, the shape, ``steps`` and ``calls``);
* ``diagnostics()``: extra numbers for the result's ``run`` key.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

NULL = -1
SAMPLE = 1024          # groups the check replays
VID_SPAN = 1 << 29     # request values are base + offset, each below this


class Spans:
    """The benchmark's own spans around its calls into the program's
    layers: host seconds per name while ``recording``, and a
    ``torch.profiler`` annotation ``gpbench.<name>`` while ``annotate``."""

    def __init__(self):
        self.recording = False
        self.annotate = False
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function("gpbench." + name)
               if self.annotate else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        if self.recording:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def rng(seed: int, stream: int) -> np.random.Generator:
    """Stream ``stream`` of the run's seed (streams never overlap)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def sample_groups(G: int, n: int, seed: int, must=()) -> np.ndarray:
    """``n`` groups drawn from the seed, with ``must`` among them, sorted."""
    pick = rng(seed, 1).choice(G, size=min(n, G), replace=False)
    return np.unique(np.concatenate([pick, np.asarray(must, dtype=np.int64)]))


def steps_per_dispatch(traffic: dict) -> int:
    n = int(traffic.get("steps_per_dispatch", 1))
    if n < 1:
        raise ValueError("steps_per_dispatch must be at least 1")
    return n


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
