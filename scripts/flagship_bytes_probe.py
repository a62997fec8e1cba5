#!/usr/bin/env python3
"""Per-channel memory-traffic probe of the flagship fused normal operator.

For each band, lowers the fused per-channel normal (adjoint∘forward,
tables-as-arguments) and prints XLA's bytes-accessed / flops next to the
measured time — locating where the memory traffic (bench
`bytes_per_app_modeled`) concentrates and how close each channel runs to
the device's published memory bandwidth (bench.PEAKS).

    python scripts/flagship_bytes_probe.py [--bands 1a,1b,...] [--pointings 4]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", default=None, help="comma list (default all 12)")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--chain", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    from bench import device_peaks
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    hbm_bw = device_peaks(jax.devices()[0].device_kind)["hbm_bytes_per_s"]

    from surfh_tpu.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu.utils.profiling import chained_time

    bands = args.bands.split(",") if args.bands else None
    setup = make_flagship_setup(npix=args.npix, bands=bands,
                                n_pointings=args.pointings)
    model, _ = make_flagship_model(setup)
    tables = model.device_tables()
    maps = jax.device_put(jnp.asarray(setup["maps"], jnp.float32))

    total_b = total_t = 0.0
    rows = []
    for c, chan in enumerate(model.channels):
        nrm = jax.jit(
            lambda x, tb, c=c: model._channel_adj_tabled(
                model._channel_fwd_tabled(x, c, tb), c, tb
            )
        )
        compiled = nrm.lower(maps, tables).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        gb = float(ca["bytes accessed"]) / 1e9
        gflop = float(ca["flops"]) / 1e9
        dt = chained_time(lambda x: nrm(x, tables), maps,
                          chain=args.chain, reps=args.reps)
        util = gb * 1e9 / dt / hbm_bw
        rows.append({"band": chan.instr.name, "ms": round(dt * 1e3, 2),
                     "GB": round(gb, 3), "GFLOP": round(gflop, 1),
                     "hbm_util": round(util, 3)})
        total_b += gb
        total_t += dt
        print(f"{chan.instr.name}: {dt*1e3:7.2f} ms  {gb:7.3f} GB  "
              f"{gflop:8.1f} GFLOP  hbm_util={util:.2f}", flush=True)
    print(json.dumps({"rows": rows, "total_GB": round(total_b, 2),
                      "total_ms": round(total_t * 1e3, 1),
                      "agg_hbm_util": round(total_b * 1e9 / total_t / hbm_bw, 3)}))


if __name__ == "__main__":
    main()
