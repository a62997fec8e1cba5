#!/usr/bin/env python3
"""Per-STAGE memory-bytes breakdown of the shipped (rank-mode) flagship
pipeline: for every channel, lower each stage of the fwd+adjoint rank
pipeline separately and report XLA bytes-accessed, flops, and measured
time, with each stage's share of the device's published memory bandwidth
(bench.PEAKS) — where the bytes of an application go and which term is
reducible.

Stages (per channel, FOV-bbox domain, tables as args):
  conv_f   λ-rank conv: DFT of M maps → rank-mixed OTF → inverse onto bbox
  win_f    composed gather (gridding∘box∘window) + folded wblur GEMM
  win_a    wblur_t GEMM + layered-prefix transpose (exact transpose of win_f)
  conv_a   exact transpose of conv_f

    python scripts/flagship_stage_bytes.py [--bands 1a,...] [--pointings 4]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _cost(compiled, key):
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get(key, 0.0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", default=None)
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--chain", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-time", action="store_true",
                    help="bytes/flops only (no on-device timing)")
    args = ap.parse_args()
    from bench import device_peaks

    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    hbm_bw = device_peaks(jax.devices()[0].device_kind)["hbm_bytes_per_s"]

    from surfh_tpu.core import fft
    from surfh_tpu.simulation.flagship import (
        make_flagship_model,
        make_flagship_setup,
    )

    bands = args.bands.split(",") if args.bands else None
    setup = make_flagship_setup(npix=args.npix, bands=bands,
                                n_pointings=args.pointings)
    model, _ = make_flagship_model(setup, conv_impl="matmul")
    tables = model.device_tables()
    maps = jax.device_put(jnp.asarray(setup["maps"], jnp.float32))
    n_tpl = int(model.templates.shape[0])

    stage_tot = {}
    rows = []
    for c, chan in enumerate(model.channels):
        t = tables["chan"][c]
        if t.get("cu") is None:
            print(f"channel {c}: rank conv off — skipping", flush=True)
            continue
        a0, b0, ha, wb = chan._tbbox
        q = n_tpl * int(np.asarray(t["cu"]).shape[1])
        K, A = chan.oshape[2], chan.oshape[3]
        P, S = len(chan.pointings), chan.oshape[1]

        # stage fns take (x, t): tables ride as jit ARGUMENTS (closed-over
        # device arrays become GB-sized HLO constants at this size)
        def conv_f(x, t):
            sotf = t["sotf_ri"]
            return fft.lmm_conv_rank(x, sotf[0], sotf[1], t["dftm"])

        def win_f(yq, t, chan=chan):
            return chan._forward_windowed_impl(
                yq, t["wpsf_q"], "dense", tables=t, bbox_in=True)

        def win_a(yc, t, chan=chan, q=q):
            return chan._adjoint_windowed_fast_impl(
                yc, q, t["wpsf_q"], tables=t, bbox_out=True)

        def conv_a(pq, t):
            sotf = t["sotf_ri"]
            return fft.lmm_conv_rank_t(
                pq, sotf[0], sotf[1], t["dftm"], n_tpl)

        stages = {
            "conv_f": (conv_f, maps),
            "win_f": (win_f, jnp.zeros((q, ha, wb), jnp.float32)),
            "win_a": (win_a, jnp.zeros((P, S, K, A), jnp.float32)),
            "conv_a": (conv_a, jnp.zeros((q, ha, wb), jnp.float32)),
        }
        row = {"band": model.channels[c].instr.name, "Q": q, "bbox": [ha, wb]}
        jsum = jax.jit(lambda v: jnp.sum(v).astype(jnp.float32))
        for name, (fn, x0) in stages.items():
            jfn = jax.jit(fn)
            compiled = jfn.lower(x0, t).compile()
            b = _cost(compiled, "bytes accessed")
            f = _cost(compiled, "flops")
            entry = {"gb": round(b / 2**30, 3), "gflops": round(f / 1e9, 2)}
            if not args.no_time:
                float(jsum(jfn(x0, t)))  # warm
                times = []
                for _ in range(args.reps):
                    tt = time.perf_counter()
                    o = None
                    for _ in range(args.chain):
                        o = jfn(x0, t)
                    float(jsum(o))
                    times.append((time.perf_counter() - tt) / args.chain)
                dt = float(np.median(times))
                entry["ms"] = round(dt * 1e3, 2)
                entry["gbps"] = round(b / dt / 1e9, 1)
                entry["hbm_util"] = round(b / dt / hbm_bw, 3)
            row[name] = entry
            agg = stage_tot.setdefault(name, {"gb": 0.0, "gflops": 0.0, "ms": 0.0})
            agg["gb"] += entry["gb"]
            agg["gflops"] += entry["gflops"]
            agg["ms"] += entry.get("ms", 0.0)
        rows.append(row)
        print(json.dumps(row), flush=True)

    total = {k: {kk: round(vv, 3) for kk, vv in v.items()}
             for k, v in stage_tot.items()}
    print(json.dumps({"stage_totals": total,
                      "sum_gb": round(sum(v["gb"] for v in stage_tot.values()), 2),
                      "sum_ms": round(sum(v["ms"] for v in stage_tot.values()), 2)}),
          flush=True)


if __name__ == "__main__":
    main()
