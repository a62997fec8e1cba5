"""Per-stage timing of the flagship pipeline AT FLAGSHIP SCALE on the device.

Times each forward/adjoint stage of one representative channel (default 1c,
the widest λ-window) in isolation through the window-local tabled path,
dispatch-chained (K dependent dispatches + one scalar fetch — no in-graph
loop, which would carry a private copy of every table).  Every large array
is a jit ARGUMENT — a closed-over device array is inlined as a literal HLO
constant, a GB-sized program at this scale.

    python scripts/flagship_breakdown.py [--band 1c] [--chain 5]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="1c")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--chain", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.core import bilinear, fft, lmm, wblur
    from surfh_tpu.simulation.flagship import make_flagship_model, make_flagship_setup

    setup = make_flagship_setup(npix=args.npix, bands=[args.band],
                                n_pointings=args.pointings, build_sotf=True)
    # conv_impl="fft": this script times hand-built stages on FULL-GRID
    # tables; the matmul mode rebases the gather plans to the FOV bbox
    # (fused-path timings live in scripts/flagship_chan_probe.py).
    model, _ = make_flagship_model(setup, conv_impl="fft")
    chan = model.channels[0]
    tables = model.device_tables()
    t = tables["chan"][0]
    maps = jax.device_put(jnp.asarray(setup["maps"], jnp.float32))
    W = chan.n_wslice
    print(f"band {args.band}: W={W}, oshape {chan.oshape}, "
          f"local {chan.local_im_shape}", flush=True)

    def timed(fn, x, extra, label):
        """Dispatch-chained median per-application time (extra = table args)."""
        jfn = jax.jit(fn)
        jsum = jax.jit(lambda v: jnp.sum(v).astype(jnp.float32))
        out = jfn(x, *extra)
        float(jsum(out))  # warm (compile both)
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            o = x
            for _ in range(args.chain):
                o = jfn(o if o.shape == x.shape else x, *extra)
            float(jsum(o))
            times.append((time.perf_counter() - t0) / args.chain)
        dt = float(np.median(times))
        print(f"  {label:<28} {dt*1e3:8.1f} ms", flush=True)
        return dt

    report = {}
    wsl = chan.wslice
    nla, nlb = chan.local_im_shape
    n_aout = chan.oshape[3]
    srf = chan.srf
    off = chan._box_offset

    # -- forward stages (tables as args everywhere) ----------------------
    def f_lmm(x, tpl):
        tpl_w = jax.lax.slice_in_dim(tpl, wsl.start, wsl.stop, axis=1)
        return lmm.lmm_maps2cube(x, tpl_w)

    cube_w = jax.jit(f_lmm)(maps, tables["tpl"])
    report["fwd_lmm"] = timed(f_lmm, maps, (tables["tpl"],), "T (LMM)")

    def f_conv(c, sotf_ri):
        sotf_w = jax.lax.complex(sotf_ri[0], sotf_ri[1])
        return fft.idft(fft.dft(c) * sotf_w, model.imshape)

    blurred = jax.jit(f_conv)(cube_w, t["sotf_ri"])
    report["fwd_fftconv"] = timed(f_conv, cube_w, (t["sotf_ri"],),
                                  "C (FFT conv x OTF)")

    def f_grid(c, idx, w):
        return jnp.stack([
            bilinear.apply_plan(idx[p], w[p], c).reshape(W, nla, nlb)
            for p in range(args.pointings)
        ])

    gridded = jax.jit(f_grid)(blurred, t["plan_idx"], t["plan_w"])
    report["fwd_grid"] = timed(f_grid, blurred, (t["plan_idx"], t["plan_w"]),
                               f"S gather x{args.pointings}")

    def f_srf_slit(g, slit_w):
        outs = []
        for p in range(args.pointings):
            windows = chan._gather_slit_windows(g[p], off, n_aout * srf)
            windows = windows.reshape(
                -1, W, n_aout, srf, windows.shape[3]).sum(axis=3)
            outs.append(windows * slit_w[:, jnp.newaxis, :, :])
        return jnp.stack(outs)

    windows = jax.jit(f_srf_slit)(gridded, t["slit_w"])
    report["fwd_srf_slit"] = timed(f_srf_slit, gridded, (t["slit_w"],),
                                   "SRF box-sum + slit weights")

    def f_blur(wd, wpsf):
        return jnp.stack([
            wblur.wblur_sum_beta_batched(wd[p], wpsf)
            for p in range(args.pointings)
        ])

    report["fwd_wblur"] = timed(f_blur, windows, (t["wpsf"],),
                                "Sig-R wblur matmul")

    # -- adjoint sub-stages ----------------------------------------------
    from surfh_tpu.core import fft as fft_mod

    S = chan.oshape[1]
    sb = chan.slit_shape[2]
    K = chan.wpsf.shape[0]
    y1 = jnp.zeros(tuple(chan.oshape), jnp.float32) + 1.0

    def a_wblur_t(yy, wpsf):
        wp2d = wpsf.reshape(K, W * sb)
        outs = []
        for p in range(args.pointings):
            y2d = jnp.transpose(yy[p], (0, 2, 1)).reshape(S * n_aout, K)
            wt = jax.lax.dot_general(
                y2d, wp2d, (((1,), (0,)), ((), ())),
                preferred_element_type=yy.dtype,
            ).reshape(S, n_aout, W, sb)
            outs.append(jnp.transpose(wt, (0, 2, 1, 3)))
        return jnp.stack(outs)

    wt = jax.jit(a_wblur_t)(y1, t["wpsf"])
    report["adj_wblur_t"] = timed(a_wblur_t, y1, (t["wpsf"],),
                                  "adj wblur_t matmul")

    def a_scatter(wts, slit_w):
        outs = []
        for p in range(args.pointings):
            w_ = wts[p] * slit_w[:, jnp.newaxis, :, :]
            up = jnp.broadcast_to(
                w_[:, :, :, jnp.newaxis, :], (S, W, n_aout, srf, sb)
            ).reshape(S, W, n_aout * srf, sb)
            outs.append(chan._scatter_slit_windows_t(up, off, nla))
        return jnp.stack(outs)

    g_t = jax.jit(a_scatter)(wt, t["slit_w"])
    report["adj_slit_scatter"] = timed(a_scatter, wt, (t["slit_w"],),
                                       "adj box/slit scatter")

    def a_grid_t(gt, tp0, tp1, tp2):
        outs = []
        for p in range(args.pointings):
            outs.append(bilinear.apply_csr_transpose_arrays(
                tp0[p], tp1[p], tp2[p], gt[p].reshape(W, -1), model.imshape))
        return sum(outs)

    tp = t["tplan"]
    if chan._tplan_kind == "csr":
        report["adj_grid_t"] = timed(a_grid_t, g_t, tuple(tp),
                                     "adj CSR gridding transpose")

    def a_conv_t(c, sotf_ri, dftm):
        return fft_mod.conv_otf_matmul_t(c, sotf_ri[0], sotf_ri[1], dftm)

    cw = jnp.zeros((W,) + model.imshape, jnp.float32) + 1.0
    if "dftm" in tables:
        report["adj_conv_t"] = timed(a_conv_t, cw, (t["sotf_ri"], tables["dftm"]),
                                     "adj conv_t (matmul)")

    # -- whole channel fwd / adj / normal (tables as args) ---------------
    def f_chan(x, tables):
        return model._channel_fwd_tabled(x, 0, tables)

    def a_chan(yy, tables):
        return model._channel_adj_tabled(yy, 0, tables)

    def n_chan(x, tables):
        return model._channel_adj_tabled(
            model._channel_fwd_tabled(x, 0, tables), 0, tables)

    report["fwd_channel"] = timed(f_chan, maps, (tables,),
                                  "channel forward (fused)")
    y0 = jax.jit(f_chan)(maps, tables)
    report["adj_channel"] = timed(a_chan, y0, (tables,),
                                  "channel adjoint (fused)")
    report["normal_channel"] = timed(n_chan, maps, (tables,),
                                     "channel normal (fused)")

    print(json.dumps({k: round(v, 4) for k, v in report.items()}), flush=True)


if __name__ == "__main__":
    main()
