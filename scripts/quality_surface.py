#!/usr/bin/env python3
"""Reconstruction-quality SURFACE at the flagship config.

One fidelity data point (one µ, noiseless, random maps — a scene hostile to
the smoothness prior) says little.  This sweeps the whole surface on the real 12-band × 4-pointing × 501²
problem: {Orion-bar, NGC 7023 stand-in} scenes × noise levels × a µ grid
spanning 5e2–5e8 (the reference's production range: µ=5e3 flagship runs,
5e8 real-data deep runs — fusion_real_data_multi_chan.py:389,443), each
solved with the production dispatch-mode CG.  µ and the data vector ride
as ARGUMENTS of one jitted CG step, so the whole sweep compiles once.

    python scripts/quality_surface.py [--niter 300] [--npix 501] \
        [--mus 5e2,5e3,5e5,5e7,5e8] [--noise 0,0.01,0.05] [--out f.json]
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
    ap.add_argument("--niter", type=int, default=300)
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--bands", type=str, default=None)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--mus", type=str, default="5e2,5e3,5e5,5e7,5e8")
    ap.add_argument("--noise", type=str, default="0,0.01,0.05",
                    help="noise rms as a fraction of the data rms")
    ap.add_argument("--scenes", type=str, default="orion,ngc7023")
    ap.add_argument("--out", type=str, default=None)
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

    from surfh_tpu.simulation.data import synthetic_ngc7023, synthetic_orion
    from surfh_tpu.simulation.flagship import (
        make_flagship_model,
        make_flagship_setup,
    )
    from surfh_tpu.config import platform_policy
    from surfh_tpu.solvers.criterion import dtd_separated
    from surfh_tpu.utils import metrics

    def mark(m):
        print(f"[{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)

    mark("build flagship model")
    bands = args.bands.split(",") if args.bands else None
    setup = make_flagship_setup(
        npix=args.npix, bands=bands, n_pointings=args.pointings,
        build_sotf=platform_policy().conv_impl == "fft",
    )
    model, _ = make_flagship_model(setup)
    n_tpl = model.templates.shape[0]
    tables = model.device_tables()
    mark(f"model ready: {len(model.channels)} channels, cube {model.cube_shape}")

    # the PRODUCTION dispatch-mode CG (solvers.cg.lcg): (µ, tables) ride
    # as traced op_args of one normal_op closure, so the whole
    # (scene × noise × µ) sweep reuses a single compiled step program
    from surfh_tpu.solvers import cg as cg_mod

    fused_normal = model._normal_fn_tabled

    def normal_op(x, mu, tables):
        return fused_normal(x, tables) + mu * dtd_separated(x)

    fwd = jax.jit(model._forward_fn_tabled)
    adj = jax.jit(model._adjoint_fn_tabled)

    def solve(b, mu, niter):
        res = cg_mod.lcg(
            normal_op, b, jnp.zeros(model.ishape, jnp.float32),
            max_iter=niter, tol=0.0, op_args=(jnp.float32(mu), tables),
            loop="dispatch",
        )
        return np.asarray(res.x), float(res.grad_norm[-1])

    # coverage mask: spatial pixels with real sensitivity
    ones = jnp.ones(model.oshape, jnp.float32)
    sens = np.abs(np.asarray(adj(ones, tables))).sum(axis=0)
    mask = sens > 0.05 * sens.max()
    mark(f"coverage mask: {mask.mean()*100:.1f}% of pixels observed")

    scene_fns = {"orion": synthetic_orion, "ngc7023": synthetic_ngc7023}
    mus = [float(m) for m in args.mus.split(",")]
    noises = [float(n) for n in args.noise.split(",")]
    rng = np.random.default_rng(0)

    rows = []
    for scene in args.scenes.split(","):
        maps, _, _, _ = scene_fns[scene](n_maps=n_tpl, size=args.npix,
                                         n_wavel=16)
        truth = (maps / maps.max()).astype(np.float32)
        t0 = time.time()
        y_clean = np.asarray(fwd(jnp.asarray(truth), tables))
        y_rms = float(np.sqrt(np.mean(y_clean**2)))
        mark(f"scene {scene}: data simulated in {time.time()-t0:.1f}s "
             f"(rms {y_rms:.3g})")
        for nz in noises:
            y = y_clean + (nz * y_rms) * rng.standard_normal(
                y_clean.shape).astype(np.float32)
            b = np.asarray(adj(jnp.asarray(y), tables))
            b_dev = jnp.asarray(b)
            for mu in mus:
                t0 = time.time()
                x, gnorm = solve(b_dev, mu, args.niter)
                dt = time.time() - t0
                row = {
                    "scene": scene, "noise_frac": nz, "mu": mu,
                    "niter": args.niter,
                    "rel_err_pct": round(float(metrics.relative_error(
                        truth[:, mask], x[:, mask])), 3),
                    "psnr": round(float(metrics.psnr(
                        truth[:, mask], x[:, mask])), 3),
                    "grad_norm_final": gnorm,
                    "solve_s": round(dt, 1),
                }
                rows.append(row)
                print(json.dumps(row), flush=True)

    # per-(scene, noise) best µ summary
    best = {}
    for r in rows:
        k = (r["scene"], r["noise_frac"])
        if k not in best or r["rel_err_pct"] < best[k]["rel_err_pct"]:
            best[k] = r
    summary = {
        "config": {"npix": args.npix, "bands": bands or "all12",
                   "pointings": args.pointings, "niter": args.niter},
        "best": [
            {"scene": s, "noise_frac": n, **{k: v for k, v in r.items()
                                             if k not in ("scene", "noise_frac")}}
            for (s, n), r in sorted(best.items())
        ],
        "rows": rows,
    }
    print(json.dumps({"summary": summary["best"]}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
        mark(f"wrote {args.out}")


if __name__ == "__main__":
    main()
