#!/usr/bin/env python3
"""Device-trace the fused flagship fwd+adjoint: true per-fusion wall times.

The XLA cost model charges granularity-padded bytes, so modeled GB
cannot localize the fused program's wall time.  The JAX profiler captures
one event per kernel on the `/device:GPU:N` planes of its xplane trace,
giving the per-kernel breakdown of an application: what is bandwidth,
what is gather, what is GEMM.

    python scripts/flagship_trace.py [--reps 3] [--top 40]
"""

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from surfh_tpu.utils.cache import cache_dir


def _hlo_metadata_map(compiled_text):
    """instruction name → 'source_file:line (op_name)' from optimized HLO."""
    import re

    out = {}
    pat = re.compile(
        r"%([\w.\-]+) = [^\n]*?metadata=\{[^}]*?"
        r"op_name=\"([^\"]*)\"[^}]*?"
        r"source_file=\"([^\"]*)\"[^}]*?source_line=(\d+)")
    for m in pat.finditer(compiled_text):
        name, op, sf, sl = m.groups()
        sf = sf.rsplit("/surfh_tpu/", 1)[-1]
        op_tail = "/".join(op.split("/")[-2:])
        out[name] = f"{sf}:{sl} ({op_tail})"
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=cache_dir("flagship_trace"))
    ap.add_argument("--attribute", action="store_true",
                    help="join device fusion times with the optimized HLO's "
                         "op metadata and report cost per source line")
    args = ap.parse_args()

    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.simulation.flagship import make_flagship_model

    def mark(m):
        print(f"[{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)

    mark("build flagship model")
    model, setup = make_flagship_model(conv_impl="auto")
    maps = jnp.asarray(setup["maps"], jnp.float32)
    tables = model.device_tables()
    mark("compile fwd+adj")
    fwd = jax.jit(model._forward_fn_tabled).lower(maps, tables).compile()
    adj = jax.jit(model._adjoint_fn_tabled).lower(
        jax.ShapeDtypeStruct(model.oshape, jnp.float32), tables).compile()
    sum_c = jax.jit(lambda g: jnp.sum(g))

    mark("warm")
    g = adj(fwd(maps, tables), tables)
    float(sum_c(g))

    mark("trace")
    import jax.profiler

    jax.profiler.start_trace(args.out)
    x = maps
    for _ in range(args.reps):
        g = adj(fwd(x, tables), tables)
        x = maps + g * 1e-30
    s = float(sum_c(g))
    jax.profiler.stop_trace()
    mark(f"trace done (sum {s:.3e}); parsing")

    traces = sorted(glob.glob(
        os.path.join(args.out, "plugins/profile/*/*.xplane.pb")))
    profile = jax.profiler.ProfileData.from_file(traces[-1])
    agg = {}
    total = 0.0
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            for e in line.events:
                dur = e.duration_ns / 1e3  # µs
                a = agg.setdefault(e.name, [0.0, 0])
                a[0] += dur
                a[1] += 1
                total += dur
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    print(json.dumps({"device_total_ms_per_app":
                      round(total / 1e3 / args.reps, 2),
                      "n_fusions": len(rows)}), flush=True)
    for n, (dur, cnt) in rows[: args.top]:
        print(json.dumps({
            "op": n[:110], "ms_per_app": round(dur / 1e3 / args.reps, 3),
            "count": cnt,
            "pct": round(100 * dur / max(total, 1e-9), 1),
        }), flush=True)

    if args.attribute:
        mark("attribute: parse optimized HLO")
        meta = {}
        for c in (fwd, adj):
            meta.update(_hlo_metadata_map(c.as_text()))
        src_agg = {}
        unattr = 0.0
        for n, (dur, cnt) in rows:
            src = meta.get(n)
            if src is None:
                unattr += dur
                continue
            a = src_agg.setdefault(src, [0.0, 0])
            a[0] += dur
            a[1] += cnt
        print(json.dumps({"attributed_pct": round(
            100 * (total - unattr) / max(total, 1e-9), 1)}), flush=True)
        for src, (dur, cnt) in sorted(src_agg.items(),
                                      key=lambda kv: -kv[1][0])[: args.top]:
            print(json.dumps({
                "src": src[:130],
                "ms_per_app": round(dur / 1e3 / args.reps, 3),
                "count": cnt,
                "pct": round(100 * dur / max(total, 1e-9), 1),
            }), flush=True)


if __name__ == "__main__":
    main()
