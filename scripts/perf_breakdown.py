#!/usr/bin/env python3
"""Per-stage timing of the flagship forward pipeline on the current device.

Times each stage jitted in isolation (LMM, global FFT conv, per-channel
gridding gather, slit-window + spectral-blur contraction) to locate the
bottleneck before optimizing.  The reference's analog is the ad-hoc FFT
benchmark scripts/perf_dft.py.

    python scripts/perf_breakdown.py [--preset medium] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PRESETS = {
    "small": dict(im_size=81, n_lambda=60, n_tpl=4, n_channels=2, n_pointings=2, n_slit=5),
    "medium": dict(im_size=251, n_lambda=250, n_tpl=4, n_channels=4, n_pointings=4, n_slit=11),
    "large": dict(im_size=501, n_lambda=600, n_tpl=4, n_channels=6, n_pointings=4, n_slit=17),
}


def timed(fn, x, reps=5, chain=10):
    """Median time of one application, amortizing host↔device round-trip
    latency by chaining `chain` dependent applications per jitted call."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(x):
        def body(i, carry):
            x, acc = carry
            out = fn(x + acc.astype(x.dtype) * 1e-30)
            return x, acc + jnp.sum(out).astype(jnp.float32)

        _, acc = jax.lax.fori_loop(0, chain, body, (x, jnp.float32(0)))
        return acc

    float(run(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(x))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / chain


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="medium", choices=list(PRESETS))
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
    from surfh_tpu.simulation.synthetic import make_model

    model, setup = make_model(dtype=jnp.float32, **PRESETS[args.preset])
    maps = jnp.asarray(setup["maps"], jnp.float32)
    print(f"devices={jax.devices()} cube={model.cube_shape} data={model.oshape}")

    tpl = model._templates_dev
    sotf = model._sotf_dev
    imshape = model.imshape

    t_lmm = timed(jax.jit(lambda m: lmm.lmm_maps2cube(m, tpl)), maps)
    cube = jax.jit(lambda m: lmm.lmm_maps2cube(m, tpl))(maps)
    t_conv = timed(jax.jit(lambda c: fft.idft(fft.dft(c) * sotf, imshape)), cube)
    blurred = jax.jit(lambda c: fft.idft(fft.dft(c) * sotf, imshape))(cube)

    t_grid = t_win = t_blur = 0.0
    for chan in model.channels:
        xw = jax.lax.slice_in_dim(blurred, chan.wslice.start, chan.wslice.stop, axis=0)
        nla, nlb = chan.local_im_shape
        idx, w = chan._plans_fwd_dev[0]
        grid_fn = jax.jit(
            lambda x, idx=idx, w=w, n=xw.shape[0], nla=nla, nlb=nlb: bilinear.apply_plan(idx, w, x).reshape(n, nla, nlb)
        )
        t_grid += timed(grid_fn, xw) * len(chan.pointings)
        gridded = grid_fn(xw)
        otf = chan.otf_combined
        sum_fn = jax.jit(lambda g, otf=otf, s=(nla, nlb): fft.idft(fft.dft(g) * otf, s))
        t_win += timed(sum_fn, gridded) * len(chan.pointings)
        summed = sum_fn(gridded)
        n_aout = chan.oshape[3]
        srf = chan.srf
        sb = chan.slit_shape[2]
        a0s, b0s = chan.slit_a_starts, chan.slit_b_starts
        wts = chan.slit_weights_sub
        wpsf = chan._wpsf_dev

        def slit_blur(s, a0s=a0s, b0s=b0s, wts=wts, wpsf=wpsf, n_aout=n_aout, srf=srf, sb=sb):
            windows = jnp.stack(
                [s[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb] for a0, b0 in zip(a0s, b0s)]
            )
            windows = windows * wts[:, jnp.newaxis, :, :]
            return wblur.wblur_sum_beta_batched(windows, wpsf)

        t_blur += timed(jax.jit(slit_blur), summed) * len(chan.pointings)

    full = jax.jit(model._forward_fn)
    t_full = timed(full, maps)
    t_adj = timed(jax.jit(model.adjoint_fn), full(maps))

    print(f"lmm (T):            {t_lmm*1e3:9.2f} ms")
    print(f"global conv (C):    {t_conv*1e3:9.2f} ms")
    print(f"gridding (S, all):  {t_grid*1e3:9.2f} ms")
    print(f"SRF conv (all):     {t_win*1e3:9.2f} ms")
    print(f"slit+wblur (all):   {t_blur*1e3:9.2f} ms")
    print(f"sum of stages:      {(t_lmm+t_conv+t_grid+t_win+t_blur)*1e3:9.2f} ms")
    print(f"full forward:       {t_full*1e3:9.2f} ms")
    print(f"full adjoint:       {t_adj*1e3:9.2f} ms")


if __name__ == "__main__":
    main()
