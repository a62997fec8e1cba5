"""Does the layered-prefix composed transpose help the FUSED channel normal?

scripts/scatter_bench.py times the layered-prefix spelling (pixels
statically sorted by segment length; layer k is a dense prefix add of a
row-gather; one final take unpermutes) against the stock sorted-COO
scatter in isolation.  This probe checks whether a difference survives
XLA's overlap inside the fused normal, by monkeypatching
`apply_composed_plan_t` with a layered implementation built from the real
per-pointing plans (discriminated by trace-time call order).

    python scripts/layered_fused_probe.py [--band 1c]
"""
import argparse, os, sys, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_layered(csrc, cw, cdst, P):
    seg = np.bincount(cdst, minlength=P)
    L = int(seg.max())
    starts = np.concatenate([[0], np.cumsum(seg)])
    perm = np.argsort(-seg, kind="stable")
    T = [int((seg > k).sum()) for k in range(L)]
    lsrc = [csrc[starts[:-1][perm[: T[k]]] + k].astype(np.int32) for k in range(L)]
    lw = [cw[starts[:-1][perm[: T[k]]] + k].astype(np.float32) for k in range(L)]
    inv = np.full(P, T[0], np.int32)
    inv[perm[: T[0]]] = np.arange(T[0], dtype=np.int32)
    return T, lsrc, lw, inv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="1c")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.core import bilinear
    from surfh_tpu.simulation.flagship import make_flagship_model, make_flagship_setup

    setup = make_flagship_setup(npix=args.npix, bands=[args.band],
                                n_pointings=args.pointings)
    model, _ = make_flagship_model(setup)
    chan = model.channels[0]
    tables = model.device_tables()
    maps = jax.device_put(jnp.asarray(setup["maps"], jnp.float32))
    ha, wb = chan._tbbox[2], chan._tbbox[3]
    P = ha * wb

    plans = []
    _i, _w, scs, sws, sds = chan._composed_stack
    for p in range(len(chan.pointings)):
        nz = sws[p] != 0
        plans.append(build_layered(scs[p][nz], sws[p][nz], sds[p][nz], P))

    def chained(nrm):
        @jax.jit
        def run(x, tb):
            def body(i, carry):
                x, acc = carry
                out = nrm(x + acc.astype(x.dtype) * 1e-30, tb)
                return x, acc + jnp.sum(out).astype(jnp.float32)

            return jax.lax.fori_loop(0, args.chain, body, (x, jnp.float32(0)))[1]

        float(run(maps, tables))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            float(run(maps, tables))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) / args.chain * 1e3

    def nrm(x, tb):
        return model._channel_adj_tabled(
            model._channel_fwd_tabled(x, 0, tb), 0, tb)

    stock = chained(nrm)
    print(f"  stock fused normal    {stock:8.2f} ms", flush=True)

    state = {"n": 0}

    def layered_t(csrc, cw, cdst, values, patch_pixels):
        T, lsrc, lw, inv = plans[state["n"] % len(plans)]
        state["n"] += 1
        # values [W, n_out] -> row form [n_out, W]
        vt = values.T
        acc = jnp.zeros((T[0], values.shape[0]), values.dtype)
        for k in range(len(T)):
            upd = jnp.take(vt, jnp.asarray(lsrc[k]), axis=0) * jnp.asarray(lw[k])[:, None]
            acc = acc.at[: T[k]].add(upd)
        accz = jnp.concatenate(
            [acc, jnp.zeros((1, values.shape[0]), values.dtype)], axis=0)
        return jnp.take(accz, jnp.asarray(inv), axis=0).T

    orig = bilinear.apply_composed_plan_t
    bilinear.apply_composed_plan_t = layered_t
    try:
        ms = chained(nrm)
    finally:
        bilinear.apply_composed_plan_t = orig
    print(f"  layered-prefix        {ms:8.2f} ms   (delta {stock - ms:+.2f})",
          flush=True)

    # correctness: single-pointing check vs stock via the model path is
    # implicit (same taps, same per-destination order); spot check:
    rngv = np.random.default_rng(0).standard_normal(
        (chan.wslice.stop - chan.wslice.start, _i.shape[2])).astype(np.float32)
    v = jax.device_put(rngv)
    state["n"] = 0
    a = np.asarray(jax.jit(
        lambda v: orig(jnp.asarray(scs[0]), jnp.asarray(sws[0].astype(np.float32)),
                       jnp.asarray(sds[0]), v, P))(v))
    b = np.asarray(jax.jit(lambda v: layered_t(None, None, None, v, P))(v))
    rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
    print(f"  check: max rel {rel:.2e}")


if __name__ == "__main__":
    main()
