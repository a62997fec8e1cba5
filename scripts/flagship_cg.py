"""The BASELINE north star at the reference's REAL scale: CG iterations of
the full 12-band fusion on one device.

Builds the flagship problem (12 MIRI bands × 4 dither pointings, 501² sky,
~3879-λ cube — scripts/main_fusion.py:34-39), simulates data through the
forward model, and runs `niter` conjugate-gradient iterations of the
quadratic fusion criterion in dispatch mode (per-iteration jitted step; the
in-graph while loop would carry a private copy of every table).  Reports
wall time, iterations/s, and the reconstruction error against the simulated
truth.

    python scripts/flagship_cg.py [--niter 500] [--bands ...] [--npix 501]
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
    ap.add_argument("--niter", type=int, default=500)
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--bands", type=str, default=None)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--mu", type=float, default=5e3)
    ap.add_argument("--method", choices=("lcg", "mmmg"), default="lcg")
    ap.add_argument("--chain", type=int, default=1,
                    help="CG iterations unrolled per dispatched program "
                         "(amortizes the per-dispatch host latency)")
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

    from surfh_tpu.config import platform_policy
    from surfh_tpu.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS
    from surfh_tpu.utils import metrics

    report = {}
    t0 = time.time()
    bands = args.bands.split(",") if args.bands else None
    setup = make_flagship_setup(
        npix=args.npix, bands=bands, n_pointings=args.pointings,
        # the FFT conv (the CPU policy) needs the materialized transfer
        # function
        build_sotf=platform_policy().conv_impl == "fft",
    )
    model, _ = make_flagship_model(setup)
    report["build_s"] = round(time.time() - t0, 1)
    print(f"[{time.strftime('%H:%M:%S')}] build {report['build_s']}s; "
          f"cube {model.cube_shape}, y {int(model._idx[-1])}, "
          f"{len(model.channels)} channels", flush=True)

    truth = np.asarray(setup["maps"], np.float32)
    t0 = time.time()
    tables = model.device_tables()
    y = model.forward(truth)
    report["simulate_s"] = round(time.time() - t0, 1)
    print(f"[{time.strftime('%H:%M:%S')}] simulate {report['simulate_s']}s",
          flush=True)

    crit = QuadCriterion_MRS(1.0, np.asarray(y), model, args.mu)
    # b = Hᵗy: pays the adjoint compile (cached across runs)
    t0 = time.time()
    _ = crit.b
    report["bTy_s"] = round(time.time() - t0, 1)

    # warm-up solve: compiles the CG step program
    t0 = time.time()
    crit.run_method(args.method, maximum_iterations=2 * args.chain,
                    solver_loop="dispatch", solver_chain=args.chain)
    report["warmup_s"] = round(time.time() - t0, 1)
    print(f"[{time.strftime('%H:%M:%S')}] b {report['bTy_s']}s, "
          f"warm-up(2 it) {report['warmup_s']}s", flush=True)

    t0 = time.time()
    res = crit.run_method(
        args.method, maximum_iterations=args.niter, solver_loop="dispatch",
        solver_chain=args.chain,
    )
    dt = time.time() - t0
    gn = np.asarray(res.grad_norm, np.float64)
    marks = [i for i in (0, 10, 32, 100, 200, 500, 1000, 2000) if i < len(gn)]
    report.update(
        method=args.method,
        mu=args.mu,
        niter=int(res.n_iter),
        solve_s=round(dt, 2),
        iters_per_s=round(res.n_iter / dt, 2),
        grad_norm_final=float(gn[-1]),
        # convergence curve checkpoints (grad-norm at iteration i, and the
        # total reduction factor) — the µ=5e8 float32 conditioning evidence
        grad_norm_marks={str(i): float(gn[i]) for i in marks},
        grad_reduction=float(gn[0] / gn[-1]) if gn[-1] > 0 else float("inf"),
        relative_error_pct=metrics.relative_error(truth, res.x),
        psnr_maps=metrics.psnr(truth, res.x),
        n_channels=len(model.channels),
        cube_shape=list(model.cube_shape),
    )
    if os.environ.get("SURFH_CG_HISTORY"):
        np.save(os.environ["SURFH_CG_HISTORY"], gn)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
