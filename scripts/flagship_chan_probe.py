"""Time one channel's fused tabled fwd/adj/normal at flagship scale on the device.

    python scripts/flagship_chan_probe.py [--band 1c] [--rtol 1e-6]
"""
import argparse, os, sys, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="1c")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--chain", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rtol", type=float, default=0.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--stages", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from surfh_tpu.simulation.flagship import make_flagship_model, make_flagship_setup

    setup = make_flagship_setup(npix=args.npix, bands=[args.band],
                                n_pointings=args.pointings)
    model, _ = make_flagship_model(setup, conv_freq_rtol=args.rtol)
    chan = model.channels[0]
    print(f"band {args.band}: W={chan.n_wslice}, supports={model.conv_supports}",
          flush=True)
    tables = model.device_tables()
    maps = jax.device_put(jnp.asarray(setup["maps"], jnp.float32))

    fwd = jax.jit(lambda x, tb: model._channel_fwd_tabled(x, 0, tb))
    adj = jax.jit(lambda y, tb: model._channel_adj_tabled(y, 0, tb))
    nrm = jax.jit(lambda x, tb: model._channel_adj_tabled(
        model._channel_fwd_tabled(x, 0, tb), 0, tb))
    jsum = jax.jit(lambda v: jnp.sum(v).astype(jnp.float32))

    def timed(jfn, x, label):
        o = jfn(x, tables); float(jsum(o))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            o = x
            for _ in range(args.chain):
                o = jfn(o if o.shape == x.shape else x, tables)
            float(jsum(o))
            times.append((time.perf_counter() - t0) / args.chain)
        dt = float(np.median(times))
        print(f"  {label:<18} {dt*1e3:8.1f} ms", flush=True)
        return dt

    y0 = fwd(maps, tables)
    timed(nrm, maps, "channel normal")
    timed(fwd, maps, "channel forward")
    timed(adj, y0, "channel adjoint")

    if args.stages:
        from surfh_tpu.core import fft

        wsl = chan.wslice

        def conv_only(x, tb):
            t = tb["chan"][0]
            tpl_w = jax.lax.slice_in_dim(tb["tpl"], wsl.start, wsl.stop, axis=1)
            return fft.lmm_conv_otf_matmul(
                x, tpl_w, t["sotf_ri"][0], t["sotf_ri"][1], t["dftm"])

        def conv_t_only(p, tb):
            t = tb["chan"][0]
            tpl_w = jax.lax.slice_in_dim(tb["tpl"], wsl.start, wsl.stop, axis=1)
            return fft.lmm_conv_otf_matmul_t(
                p, tpl_w, t["sotf_ri"][0], t["sotf_ri"][1], t["dftm"])

        # under the flagship default (rank mode + host materialize) the raw
        # wpsf is dropped from the tables (spectro.py); fall back to the
        # channel's device copy so --stages keeps working
        def _wpsf(t):
            return t["wpsf"] if "wpsf" in t else chan._wpsf_dev

        def mid_fwd(b, tb):
            t = tb["chan"][0]
            return chan._forward_windowed_impl(b, _wpsf(t), "dense", tables=t)

        def mid_adj(y, tb):
            t = tb["chan"][0]
            return chan._adjoint_windowed_fast_impl(
                y, chan.n_wslice, _wpsf(t), tables=t, bbox_out=True)

        jconv = jax.jit(conv_only)
        blurred = jconv(maps, tables)
        timed(jconv, maps, "  conv (fused T.C)")
        timed(jax.jit(mid_fwd), blurred, "  middle fwd (S.L.R.Sig)")
        patch = jax.jit(mid_adj)(y0, tables)
        timed(jax.jit(mid_adj), y0, "  middle adj")
        timed(jax.jit(conv_t_only), patch, "  conv_t (fused)")

if __name__ == "__main__":
    main()
