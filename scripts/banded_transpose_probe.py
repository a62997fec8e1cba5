"""A/B probe: banded dynamic-window respelling of the composed transpose.

The rows-form transpose gathers ~209k single rows of vt [n_out≈9k, Q≈24]
per band-pointing, each a separate small memory transaction.  But the
tap sources are near-monotone in the destination row (gather_locality_
probe: median step 1, 86% of steps <8), so blocks of T_b consecutive
destination rows read from a narrow src window.  This respells the local
majority as NB dense [T_b, S_w] banded-weight matmuls against contiguous
vt windows — ~19x fewer gathered rows — with the non-local tail kept on
the old take path.  Times both spellings on the device with an in-graph
chained loop and checks they compute the same map.

    python scripts/banded_transpose_probe.py [--band 4a] [--npix 501]
        [--tb 512] [--sw 64] [--chain 30] [--cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_banded(buckets, n_out, tb, sw, dtype=np.float32):
    """Taps (dst,src,w) from rows-form buckets → banded + outlier-COO plan.

    Returns (starts [NB], wb [NB, tb, sw], out_src [K], out_w [K],
    out_dst [K], t0) with outliers zero-padded to a fixed K.
    """
    taps = []  # (dst, src, w)
    t0 = max(s.shape[1] for s, _ in buckets)
    for src_g, wgt_g in buckets:
        lg, tg = src_g.shape
        for l in range(lg):
            dst = np.arange(tg, dtype=np.int64)
            m = wgt_g[l] != 0
            taps.append((dst[m], src_g[l][m].astype(np.int64), wgt_g[l][m]))
    dst = np.concatenate([t[0] for t in taps])
    src = np.concatenate([t[1] for t in taps])
    w = np.concatenate([t[2] for t in taps]).astype(dtype)

    nb = (t0 + tb - 1) // tb
    starts = np.zeros(nb, np.int32)
    wb = np.zeros((nb, tb, sw), dtype)
    out = []  # outlier taps
    order = np.argsort(dst, kind="stable")
    dst, src, w = dst[order], src[order], w[order]
    block = dst // tb
    bounds = np.searchsorted(block, np.arange(nb + 1))
    for b in range(nb):
        lo, hi = bounds[b], bounds[b + 1]
        if lo == hi:
            continue
        sb, se = src[lo:hi], None
        s0 = int(np.clip(np.median(sb) - sw // 2, 0, max(n_out - sw, 0)))
        starts[b] = s0
        off = sb - s0
        loc = (off >= 0) & (off < sw)
        d_loc = dst[lo:hi][loc] - b * tb
        np.add.at(wb[b], (d_loc, off[loc]), w[lo:hi][loc])
        nl = ~loc
        if nl.any():
            out.append((dst[lo:hi][nl], sb[nl], w[lo:hi][nl]))
    if out:
        od = np.concatenate([o[0] for o in out]).astype(np.int32)
        osrc = np.concatenate([o[1] for o in out]).astype(np.int32)
        ow = np.concatenate([o[2] for o in out]).astype(dtype)
    else:
        od = np.zeros(1, np.int32)
        osrc = np.zeros(1, np.int32)
        ow = np.zeros(1, dtype)
    return starts, wb, osrc, ow, od, t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="4a")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--tb", type=int, default=512)
    ap.add_argument("--sw", type=int, default=64)
    ap.add_argument("--chain", type=int, default=30)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.simulation.flagship import make_flagship_setup, make_flagship_model
    from surfh_tpu.core import bilinear

    setup = make_flagship_setup(
        npix=args.npix, bands=[args.band], n_pointings=1, build_sotf=False
    )
    model, _ = make_flagship_model(setup)
    ch = model.channels[0]
    assert ch._composed_t_impl == "rows", ch._composed_t_impl
    stack = ch._composed_t_stack
    linv = np.asarray(stack[0][0])
    buckets = [
        (np.asarray(stack[1 + 2 * i][0]), np.asarray(stack[2 + 2 * i][0]))
        for i in range((len(stack) - 1) // 2)
    ]
    n_out = int(max(int(s.max()) for s, _ in buckets)) + 1
    W = 24

    t_host = time.time()
    starts, wb, osrc, ow, od, t0 = build_banded(
        buckets, n_out, args.tb, args.sw
    )
    nb = starts.shape[0]
    n_taps = int(sum((g != 0).sum() for _, g in buckets))
    n_outliers = int((ow != 0).sum())
    rep = {
        "band": args.band,
        "n_out": n_out,
        "t0": t0,
        "taps": n_taps,
        "outliers": n_outliers,
        "outlier_frac": round(n_outliers / n_taps, 4),
        "nb": nb,
        "tb": args.tb,
        "sw": args.sw,
        "wb_mb": round(wb.nbytes / 1e6, 1),
        "build_s": round(time.time() - t_host, 1),
    }
    print(json.dumps(rep), flush=True)

    rng = np.random.default_rng(0)
    values = jnp.asarray(rng.standard_normal((W, n_out)).astype(np.float32))

    startsd = jnp.asarray(starts)
    wbd = jnp.asarray(wb)
    osrcd, owd, odd = jnp.asarray(osrc), jnp.asarray(ow), jnp.asarray(od)
    bucketsd = [(jnp.asarray(s), jnp.asarray(g)) for s, g in buckets]
    linvd = jnp.asarray(linv)

    def rows_impl(vals):
        return bilinear.apply_composed_plan_rows_t(linvd, bucketsd, vals)

    idx = starts[:, None] + np.arange(args.sw)[None, :]
    idxd = jnp.asarray(idx.reshape(-1))

    def banded_impl(vals):
        vt = vals.T  # [n_out, W]
        g = jnp.take(vt, idxd, axis=0).reshape(nb, args.sw, W)
        acc = jnp.einsum("bts,bsw->btw", wbd, g,
                         precision=jax.lax.Precision.HIGHEST)
        acc = acc.reshape(nb * args.tb, W)[:t0]
        # outlier tail on the old path
        contrib = jnp.take(vt, osrcd, axis=0) * owd[:, None]
        acc = acc.at[odd].add(contrib)
        accz = jnp.concatenate([acc, jnp.zeros((1, W), vals.dtype)], axis=0)
        return jnp.take(accz, linvd, axis=0).T

    # correctness
    r = np.asarray(rows_impl(values))
    b = np.asarray(banded_impl(values))
    err = float(np.max(np.abs(r - b)) / max(np.max(np.abs(r)), 1e-30))
    print(json.dumps({"max_rel_err": err}), flush=True)

    def chained(fn):
        @jax.jit
        def run(x):
            def body(i, carry):
                x, acc = carry
                out = fn(x + acc * 1e-30)
                return x, acc + jnp.sum(out)

            return jax.lax.fori_loop(0, args.chain, body, (x, jnp.float32(0)))[1]

        float(run(values))  # compile+warm
        ts = []
        for _ in range(args.reps):
            tt = time.perf_counter()
            float(run(values))
            ts.append((time.perf_counter() - tt) / args.chain * 1e3)
        return round(float(np.median(ts)), 3)

    rows_ms = chained(rows_impl)
    banded_ms = chained(banded_impl)
    print(
        json.dumps(
            {"rows_ms": rows_ms, "banded_ms": banded_ms,
             "speedup": round(rows_ms / banded_ms, 2)}
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
