"""Is the adjoint window transpose's gather cost index-pattern-bound?

XLA's cost model charges every gathered row of vt [n_out, Q≈20-24 f32] of
win_a — the rows-form composed transpose — a full aligned memory
transaction.  Whether the REAL memory traffic depends on index locality
decides if a renumbering of the accumulator rows (sorting taps by source)
is an app-level lever or a no-op.  This probe times
`jnp.take(vt, src, axis=0)` + the bucket einsum on the device with the
ACTUAL flagship plan indices vs sorted /
random / sequential controls, at the real Q and at Q=128 (lane-filling
control).

    python scripts/gather_locality_probe.py [--band 4a] [--npix 501]
        [--reps 30] [--cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def locality_stats(src):
    d = np.abs(np.diff(src.astype(np.int64)))
    return {
        "n": int(src.size),
        "monotone_frac": float(np.mean(np.diff(src.astype(np.int64)) >= 0)),
        "median_abs_step": float(np.median(d)),
        "frac_step_lt8": float(np.mean(d < 8)),
        "frac_step_lt64": float(np.mean(d < 64)),
        "span": int(src.max() - src.min()) if src.size else 0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="4a")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.simulation.flagship import make_flagship_setup, make_flagship_model

    setup = make_flagship_setup(
        npix=args.npix, bands=[args.band], n_pointings=1, build_sotf=False
    )
    model, _ = make_flagship_model(setup)
    ch = model.channels[0]
    assert ch._composed_t_impl == "rows", ch._composed_t_impl
    stack = ch._composed_t_stack
    buckets = [
        (np.asarray(stack[1 + 2 * i][0]), np.asarray(stack[2 + 2 * i][0]))
        for i in range((len(stack) - 1) // 2)
    ]
    # n_out: window-value count the sources index into
    n_out = int(max(int(s.max()) for s, _ in buckets)) + 1
    q = int(ch.q_planes) if hasattr(ch, "q_planes") else 24
    # the plane width W the transpose actually sees = the wblur_t output's
    # leading dim; derive from the model's conv support metadata if present
    report = {"band": args.band, "npix": args.npix, "n_out": n_out,
              "buckets": []}

    for bi, (src_g, wgt_g) in enumerate(buckets):
        flat = src_g.reshape(-1)
        report["buckets"].append(
            {"shape": list(src_g.shape), "stats": locality_stats(flat)}
        )

    # --- device timing: bucket-0 pattern vs controls ---------------------
    src0 = buckets[0][0]
    wgt0 = buckets[0][1].astype(np.float32)
    rng = np.random.default_rng(0)

    def variants(src):
        flat = src.reshape(-1)
        return {
            "real": src,
            "sorted": np.sort(flat).reshape(src.shape),
            "random": rng.permutation(
                rng.integers(0, n_out, flat.size).astype(src.dtype)
            ).reshape(src.shape),
            "arange": (np.arange(flat.size, dtype=src.dtype) % n_out).reshape(
                src.shape
            ),
        }

    def bench(src, w, vt):
        lg, tg = src.shape

        @jax.jit
        def f(vt, srcd, wd):
            g = jnp.take(vt, srcd.reshape(-1), axis=0).reshape(lg, tg, vt.shape[1])
            return jnp.einsum("ltw,lt->tw", g, wd)

        srcd = jnp.asarray(src)
        wd = jnp.asarray(w)
        out = f(vt, srcd, wd)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = f(vt, srcd, wd)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.reps * 1e3

    for W in (24, 128):
        vt = jnp.asarray(rng.standard_normal((n_out, W)).astype(np.float32))
        row = {}
        for name, src in variants(src0).items():
            ms = bench(src, wgt0, vt)
            useful_gb = src0.size * W * 4 / 1e9
            row[name] = {
                "ms": round(ms, 3),
                "eff_gbps_useful": round(useful_gb / (ms / 1e3), 1),
            }
        report[f"timing_W{W}"] = row
        print(json.dumps({f"W{W}": row}), flush=True)

    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
