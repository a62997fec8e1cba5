#!/usr/bin/env python3
"""Flagship-scale fidelity audit of the λ-rank factorized conv: measure, on
the device at the full 12-band scale, the dense-vs-rank
forward/adjoint deviation and the CG solution delta for the shipped
`conv_rank_rtol`, against the recorded SVD tails.

Phases (run separately to bound process device memory/RAM):

    python scripts/rank_fidelity_audit.py --phase deviation
    python scripts/rank_fidelity_audit.py --phase cg --rank-mode rank
    python scripts/rank_fidelity_audit.py --phase cg --rank-mode dense

Results are appended to .surfh_cache/rank_audit/rank_audit.json; the CG
phases save solutions to .surfh_cache/rank_audit/x_{rank,dense}.npy for the
cross-comparison.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from surfh_tpu.utils.cache import cache_dir

OUT = os.path.join(cache_dir("rank_audit"), "rank_audit.json")


def _record(update: dict):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    data = json.load(open(OUT)) if os.path.exists(OUT) else {}
    data.update(update)
    json.dump(data, open(OUT, "w"), indent=1)
    print(json.dumps(update), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("deviation", "cg"), required=True)
    ap.add_argument("--rank-mode", choices=("rank", "dense"), default="rank")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--bands", default=None)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--niter", type=int, default=500)
    ap.add_argument("--mu", type=float, default=5e3)
    ap.add_argument("--rank-rtol", type=float, default=1e-7)
    args = ap.parse_args()

    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.simulation.flagship import (
        make_flagship_model,
        make_flagship_setup,
    )

    bands = args.bands.split(",") if args.bands else None
    t0 = time.time()
    setup = make_flagship_setup(
        npix=args.npix, bands=bands, n_pointings=args.pointings
    )
    print(f"setup {time.time()-t0:.1f}s", flush=True)

    def build(rank_rtol):
        model, _ = make_flagship_model(
            setup, conv_impl="matmul", conv_rank_rtol=rank_rtol
        )
        return model

    if args.phase == "deviation":
        t0 = time.time()
        dense = build(0.0)
        rank = build(args.rank_rtol)
        rank.host_tables()
        tails = [s.get("rank_tail", 0.0) for s in rank.conv_supports]
        ranks = [s.get("rank") for s in rank.conv_supports]
        print(f"build both {time.time()-t0:.1f}s ranks={ranks}", flush=True)

        maps = jnp.asarray(setup["maps"], jnp.float32)
        td, tr = dense.device_tables(), rank.device_tables()
        fd = jax.jit(dense._forward_fn_tabled)
        fr = jax.jit(rank._forward_fn_tabled)
        t0 = time.time()
        yd = np.asarray(fd(maps, td))
        print(f"dense fwd (incl compile) {time.time()-t0:.1f}s", flush=True)
        t0 = time.time()
        yr = np.asarray(fr(maps, tr))
        print(f"rank fwd (incl compile) {time.time()-t0:.1f}s", flush=True)
        scale = float(np.abs(yd).max())
        fwd_max_rel = float(np.abs(yr - yd).max() / scale)
        fwd_rms_rel = float(
            np.sqrt(np.mean((yr - yd) ** 2)) / np.sqrt(np.mean(yd**2))
        )

        rng = np.random.default_rng(0)
        yy = jnp.asarray(rng.standard_normal(dense.oshape), jnp.float32)
        ad = np.asarray(jax.jit(dense._adjoint_fn_tabled)(yy, td))
        ar = np.asarray(jax.jit(rank._adjoint_fn_tabled)(yy, tr))
        ascale = float(np.abs(ad).max())
        adj_max_rel = float(np.abs(ar - ad).max() / ascale)
        adj_rms_rel = float(
            np.sqrt(np.mean((ar - ad) ** 2)) / np.sqrt(np.mean(ad**2))
        )
        max_tail = float(max(tails))
        _record({
            "bands": bands or "all12",
            "rank_rtol": args.rank_rtol,
            "ranks": ranks,
            "svd_tails": tails,
            "max_tail": max_tail,
            "fwd_max_rel": fwd_max_rel,
            "fwd_rms_rel": fwd_rms_rel,
            "adj_max_rel": adj_max_rel,
            "adj_rms_rel": adj_rms_rel,
            # the measured constant that replaces the 50x test fudge
            "fwd_dev_over_tail": fwd_max_rel / max_tail if max_tail else None,
            "adj_dev_over_tail": adj_max_rel / max_tail if max_tail else None,
        })
        return

    # --- CG phase -------------------------------------------------------
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS
    from surfh_tpu.utils import metrics

    model = build(args.rank_rtol if args.rank_mode == "rank" else 0.0)
    truth = np.asarray(setup["maps"], np.float32)
    t0 = time.time()
    y = model.forward(truth)
    print(f"simulate {time.time()-t0:.1f}s", flush=True)
    crit = QuadCriterion_MRS(1.0, np.asarray(y), model, args.mu)
    crit.run_method("lcg", 2, solver_loop="dispatch")  # warm
    t0 = time.time()
    res = crit.run_method(
        "lcg", maximum_iterations=args.niter, solver_loop="dispatch"
    )
    dt = time.time() - t0
    x = np.asarray(res.x)
    np.save(os.path.join(cache_dir("rank_audit"), f"x_{args.rank_mode}.npy"), x)
    upd = {
        f"cg_{args.rank_mode}": {
            "niter": int(res.n_iter),
            "solve_s": round(dt, 1),
            "relative_error_pct": metrics.relative_error(truth, x),
            "psnr_maps": metrics.psnr(truth, x),
            "grad_norm_final": float(res.grad_norm[-1]),
        }
    }
    other = os.path.join(
        cache_dir("rank_audit"),
        f"x_{'dense' if args.rank_mode == 'rank' else 'rank'}.npy")
    if os.path.exists(other):
        xo = np.load(other)
        upd["cg_cross"] = {
            "x_rel_err_pct": metrics.relative_error(xo, x),
            "x_max_rel": float(
                np.abs(x - xo).max() / max(np.abs(xo).max(), 1e-30)
            ),
        }
    _record(upd)


if __name__ == "__main__":
    main()
