"""Bound the end-to-end value of a faster composed transpose.

Times the fused channel normal twice: stock, and with
`apply_composed_plan_t` monkeypatched to a shape-correct O(n_out·W) pad
(keeps the upstream wblur_t chain live, makes the scatter ~free).  The
difference is the MOST any scatter kernel can buy in the fused program.

    python scripts/scatter_ceiling_probe.py [--band 1c]
"""
import argparse, os, sys, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="1c")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.core import bilinear
    from surfh_tpu.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu.utils.profiling import chained_time

    setup = make_flagship_setup(npix=args.npix, bands=[args.band],
                                n_pointings=args.pointings)
    model, _ = make_flagship_model(setup)
    tables = model.device_tables()
    maps = jax.device_put(jnp.asarray(setup["maps"], jnp.float32))

    def chained(make_nrm):
        # tables threaded as jit ARGS (closed-over device arrays become
        # inline HLO constants and blow the remote-compile upload limit)
        @jax.jit
        def run(x, tb):
            def body(i, carry):
                x, acc = carry
                out = make_nrm(x + acc.astype(x.dtype) * 1e-30, tb)
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

    ms = chained(nrm)
    print(f"  stock fused normal   {ms:8.2f} ms", flush=True)

    orig = bilinear.apply_composed_plan_t

    def stub(csrc, cw, cdst, values, patch_pixels):
        n = values.shape[-1]
        pad = [(0, 0)] * (values.ndim - 1) + [(0, patch_pixels - n)]
        return jnp.pad(values * cw[0], pad)

    bilinear.apply_composed_plan_t = stub
    try:
        ms2 = chained(nrm)
    finally:
        bilinear.apply_composed_plan_t = orig
    print(f"  stubbed-scatter      {ms2:8.2f} ms   (ceiling win "
          f"{ms - ms2:.2f} ms/channel·{args.pointings}pt)", flush=True)


if __name__ == "__main__":
    main()
