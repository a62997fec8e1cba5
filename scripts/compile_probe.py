"""Compile-time probe of the 12-band flagship model.

Builds the real-MIRI multi-band fusion operator and times the XLA compile of
the jitted forward and hand-optimized adjoint.  A Python unroll of slits ×
pointings × channels made the 12-band adjoint a ~30-min XLA-CPU compile;
the scanned/batched pipeline brings this to O(minutes).

Usage:
    python scripts/compile_probe.py [--bands 1a,2a,...|all] [--npix 101]
        [--pointings 4] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", default="all")
    ap.add_argument("--npix", type=int, default=101)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--adjoint", action="store_true", help="also compile the adjoint")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from surfh_tpu.core.fft import ir2fr
    from surfh_tpu.instrument import miri
    from surfh_tpu.instrument.geometry import Coord, CoordList, get_step
    from surfh_tpu.models.spectro import SpectroSigRLSCT
    from surfh_tpu.utils.psf import gaussian_psf

    bands = miri.BANDS if args.bands == "all" else args.bands.split(",")
    t0 = time.perf_counter()
    instrs = miri.fusion_bands(bands)
    step = get_step([i.det_pix_size for i in instrs])
    step_degree = step / 3600
    N = args.npix
    alpha = (np.arange(N) - N / 2) * step_degree
    beta = (np.arange(N) - N / 2) * step_degree
    # global λ axis = union of the band tables at the reference's density
    wavel = np.unique(np.concatenate([i.wavel_axis for i in instrs]))
    print(f"bands={bands} npix={N} n_lambda={len(wavel)} "
          f"pointings={args.pointings} step={step:.4f}\"", flush=True)
    n_tpl = 4
    rng = np.random.default_rng(0)
    tpl = np.abs(rng.standard_normal((n_tpl, len(wavel)))) + 0.1
    spsf = gaussian_psf(wavel, step)
    c = (spsf.shape[1] - N) // 2
    if c >= 0:
        spsf = spsf[:, c : c + N, c : c + N]
    else:
        pad = -c
        spsf = np.pad(spsf, ((0, 0), (pad, N - spsf.shape[1] - pad),
                             (pad, N - spsf.shape[2] - pad)))
    spsf /= spsf.sum(axis=(1, 2), keepdims=True)
    sotf = ir2fr(spsf, (N, N))
    dith = np.asarray(miri.dithering)[: args.pointings]
    pts = CoordList.from_array(dith * 1.0 / 3600.0)
    model = SpectroSigRLSCT(
        sotf, tpl, alpha, beta, wavel, instrs,
        step_degree, [pts] * len(instrs), dtype=jnp.float32,
    )
    t_build = time.perf_counter() - t0
    print(f"model build: {t_build:.1f} s  oshape={model.oshape} "
          f"cube={model.cube_shape}", flush=True)

    maps = jnp.asarray(rng.standard_normal((n_tpl, N, N)), jnp.float32)
    t0 = time.perf_counter()
    fwd = jax.jit(model._forward_fn).lower(maps).compile()
    t_fwd = time.perf_counter() - t0
    print(f"forward compile: {t_fwd:.1f} s", flush=True)
    t0 = time.perf_counter()
    y = fwd(maps)
    y.block_until_ready()
    print(f"forward run: {time.perf_counter() - t0:.2f} s  y={y.shape}", flush=True)

    if args.adjoint:
        t0 = time.perf_counter()
        adj = jax.jit(model.adjoint_fn).lower(y).compile()
        t_adj = time.perf_counter() - t0
        print(f"adjoint compile: {t_adj:.1f} s", flush=True)
        t0 = time.perf_counter()
        x = adj(y)
        x.block_until_ready()
        print(f"adjoint run: {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
