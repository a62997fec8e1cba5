"""Record CPU baselines for bench.py's synthetic presets (small/medium/large).

Runs the reference-equivalent serial NumPy path (surfh_tpu.core.numpy_ref) on
each preset's problem and records the median fwd+adjoint wall time in
baseline_cpu.json, so no bench invocation ever re-measures a CPU baseline
in-process.

    python scripts/measure_preset_baselines.py [--presets small,medium,large]
                                               [--reps 3]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets", type=str, default="small,medium,large")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import bench
    from surfh_tpu.core import numpy_ref
    from surfh_tpu.simulation.synthetic import make_model

    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "baseline_cpu.json",
    )
    recorded = {}
    if os.path.exists(out):
        with open(out) as fh:
            recorded = json.load(fh)

    for preset in args.presets.split(","):
        cfg = bench.PRESETS[preset]
        model, setup = make_model(dtype=jnp.float32, **cfg)
        x64 = np.asarray(setup["maps"], np.float64)
        times = []
        for r in range(args.reps):
            t0 = time.perf_counter()
            y = numpy_ref.spectro_forward(model, x64)
            numpy_ref.spectro_adjoint(model, y)
            times.append(time.perf_counter() - t0)
            print(f"{preset} rep {r}: {times[-1]:.2f}s", flush=True)
        recorded[preset] = {
            "seconds": float(np.median(times)),
            "config": (
                f"numpy_ref float64, scipy.fft workers=-1, "
                f"OMP/BLAS threads=1 on {os.cpu_count()} vCPU, "
                f"median of {len(times)} "
                f"(spread {min(times):.2f}-{max(times):.2f}s)"
            ),
        }
        with open(out, "w") as fh:
            json.dump(recorded, fh, indent=1)
        print(json.dumps({preset: recorded[preset]}), flush=True)


if __name__ == "__main__":
    main()
