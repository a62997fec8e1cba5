"""Measure the recorded CPU baseline for `bench.py`'s flagship preset.

Runs the reference-equivalent serial NumPy path (`surfh_tpu.core.numpy_ref`,
the same per-channel/pointing/slit loop structure as the reference's
CPU implementation — /root/reference/surfh/Models/spectroModel.py) on the
flagship problem (12 MIRI bands × 4 pointings, 501², ~3879 λ) and records
the median fwd+adjoint wall time in `baseline_cpu.json`, which `bench.py`
reads so the driver's bench run doesn't pay an hours-long CPU measurement.

    python scripts/measure_flagship_baseline.py [--reps 1] [--bands ...]

The measurement config (thread count, BLAS, dtype, reps) is recorded next
to the number: a pinned baseline instead of an in-process one that swung
4× between runs.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pin the math threading before numpy/scipy import so the measurement is
# reproducible on any machine (this image has 1 vCPU anyway).
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--bands", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from surfh_tpu.core import numpy_ref
    from surfh_tpu.simulation.flagship import (
        make_flagship_model,
        make_flagship_setup,
    )

    t0 = time.time()
    bands = args.bands.split(",") if args.bands else None
    setup = make_flagship_setup(
        npix=args.npix, bands=bands, n_pointings=args.pointings,
        build_sotf=True,  # the numpy_ref path applies the transfer function
    )
    model, _ = make_flagship_model(setup)
    print(
        f"build {time.time()-t0:.0f}s; cube {model.cube_shape}, "
        f"y {int(model._idx[-1])}, {len(model.channels)} channels",
        flush=True,
    )

    x64 = np.asarray(setup["maps"], np.float64)
    times = []
    for r in range(args.reps):
        t0 = time.time()
        y = numpy_ref.spectro_forward(model, x64)
        t_fwd = time.time() - t0
        t0 = time.time()
        numpy_ref.spectro_adjoint(model, y)
        t_adj = time.time() - t0
        times.append(t_fwd + t_adj)
        print(
            f"rep {r}: fwd {t_fwd:.1f}s adj {t_adj:.1f}s total {times[-1]:.1f}s",
            flush=True,
        )

    seconds = float(np.median(times))
    entry = {
        "seconds": seconds,
        "config": (
            f"numpy_ref float64 serial (reference loop structure), "
            f"OMP/BLAS threads=1, scipy.fft workers=-1 on {os.cpu_count()} vCPU, "
            f"npix={args.npix}, bands={bands or 'all 12'}, "
            f"pointings={args.pointings}, median of {args.reps}"
        ),
    }
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "baseline_cpu.json",
    )
    recorded = {}
    if os.path.exists(out):
        with open(out) as fh:
            recorded = json.load(fh)
    key = "flagship" if args.npix == 501 and bands is None else (
        f"flagship_n{args.npix}_b{len(bands or [0]*12)}_p{args.pointings}"
    )
    recorded[key] = entry
    with open(out, "w") as fh:
        json.dump(recorded, fh, indent=1)
    print(json.dumps({key: entry}), flush=True)


if __name__ == "__main__":
    main()
