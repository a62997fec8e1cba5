"""Tracing / profiling utilities.

The reference had no systematic profiling (ad-hoc wall-clock prints around
solver runs, fusion_CT.py:192-234; a standalone FFT benchmark,
scripts/perf_dft.py).  Here: named phase timers with a summary table,
`jax.profiler` trace capture, a chained-execution timer that amortizes
per-dispatch host latency, and the GPU card's name and power limit.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class PhaseTimer:
    """Accumulating named wall-clock phases.

    >>> timer = PhaseTimer()
    >>> with timer("forward"):
    ...     y = model.forward(x)
    >>> print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = ["phase                    total      calls    per-call"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            rows.append(f"{name:<22} {t:9.3f}s {n:8d} {t / n * 1e3:9.2f}ms")
        return "\n".join(rows)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


def card_info() -> str:
    """The GPUs' `name, power.limit` lines from `nvidia-smi`, run as a child
    process that does not import JAX (a second JAX process would reserve
    memory on the card).  A card below its maximum power limit runs slower
    under load, so every measurement is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `jax.profiler` trace (view with TensorBoard / Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def chained_time(fn, x, chain: int = 10, reps: int = 3) -> float:
    """Median seconds per application of maps→anything `fn`, running `chain`
    dependent applications per jitted dispatch so per-call host latency
    doesn't pollute the measurement."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(x):
        def body(i, carry):
            x, acc = carry
            out = fn(x + acc.astype(x.dtype) * 1e-30)
            return x, acc + jnp.sum(out).astype(jnp.float32)

        return jax.lax.fori_loop(0, chain, body, (x, jnp.float32(0)))[1]

    float(run(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(x))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / chain
