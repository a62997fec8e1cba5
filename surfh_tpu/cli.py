"""Command-line entry points.

Mirrors the reference CLI (`scripts/main_fusion.py:215-273`: fusion dir, npix,
hyperparameter µ, niter, n_templates, scale_data, method) and adds what the
reference hard-codes in scripts: a fully simulated end-to-end fusion, the
single-λ 2-D deconvolution, the closed-form expsol path, device-mesh
sharding, and checkpoint/resume.

Usage:
    python -m surfh_tpu.cli fusion --simulated -ni 50 -hp 5e3 -m lcg
    python -m surfh_tpu.cli deconv2d --niter 200
    python -m surfh_tpu.cli info

Every command prints one JSON object on stdout; logs go to stderr.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger("surfh_tpu")


class UsageError(Exception):
    """A command-line usage error (reported with the usage line, exit 2)."""


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _existing_path(value: str) -> str:
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
    return value


# --------------------------------------------------------------------------
# commands
def fusion(args):
    """Multi-channel multi-observation LMM fusion (the flagship run)."""
    from .simulation.synthetic import make_model
    from .solvers.checkpoint import run_checkpointed
    from .solvers.criterion import QuadCriterion_MRS
    from .utils import metrics

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    os.makedirs(args.output_dir, exist_ok=True)

    if not args.simulated and args.fusion_data is None:
        raise UsageError("provide --fusion-data DIR or --simulated")
    if not args.simulated:
        from .pipeline import run_real_fusion

        bands = sorted(
            {f.split("_")[0].lower() for f in os.listdir(os.path.join(args.fusion_data, "Filtered_slices")) if f.endswith(".fits")}
        )
        logger.info("real-data fusion: bands %s", bands)
        res, model = run_real_fusion(
            args.fusion_data, bands, npix=args.npix, mu=args.hyper_parameter,
            niter=args.niter, method=args.method, scale_data=args.scale_data,
            output_dir=args.output_dir, checkpoint_every=args.checkpoint_every,
        )
        _emit({"method": args.method, "niter": int(res.n_iter),
               "final_grad_norm": float(res.grad_norm[-1])})
        return

    logger.info("building simulated model: %d² grid, %dλ, %d bands, %d pointings",
                args.npix, args.n_lambda, args.channels, args.pointings)
    model, setup = make_model(
        im_size=args.npix, n_lambda=args.n_lambda, n_tpl=args.n_templates,
        n_channels=args.channels, n_pointings=args.pointings,
    )
    truth = np.asarray(setup["maps"], np.float32)
    t0 = time.perf_counter()
    y = np.asarray(model.forward(truth))
    if args.noise_snr > 0:
        rng = np.random.default_rng(0)
        sigma = np.sqrt(np.mean(y**2) / 10 ** (args.noise_snr / 10))
        y = y + rng.normal(0, sigma, y.shape).astype(y.dtype)
    logger.info("data synthesized in %.2fs (%d samples)", time.perf_counter() - t0, y.size)

    t0 = time.perf_counter()
    if args.sharded:
        from .parallel.fusion import ShardedSpectro, make_mesh

        sh = ShardedSpectro(model, make_mesh())
        res = sh.solve(y, mu_reg=args.hyper_parameter, max_iter=args.niter,
                       method=args.method)
    else:
        crit = QuadCriterion_MRS(1.0, y, model, args.hyper_parameter,
                                 printing=args.verbose)
        res = run_checkpointed(
            crit, method=args.method, niter=args.niter,
            checkpoint_path=os.path.join(args.output_dir, "solver_state.npz"),
            checkpoint_every=args.checkpoint_every,
        )
    dt = time.perf_counter() - t0
    logger.info("%s: %d iterations in %.2fs (%.2f it/s)", args.method,
                res.n_iter, dt, res.n_iter / max(dt, 1e-9))

    res_cube = np.asarray(model.mapsToCube(res.x))
    np.save(os.path.join(args.output_dir, "res_x.npy"), res.x)
    np.save(os.path.join(args.output_dir, "res_cube.npy"), res_cube)
    np.save(os.path.join(args.output_dir, "criterion.npy"), res.grad_norm)

    _emit({
        "method": args.method,
        "niter": int(res.n_iter),
        "seconds": dt,
        "iters_per_s": res.n_iter / max(dt, 1e-9),
        "psnr_maps": metrics.psnr(truth, res.x),
        "relative_error_pct": metrics.relative_error(truth, res.x),
    })


def deconv_cube(args):
    """λ-stack no-rotation cube deconvolution (BASELINE config 2, reference
    scripts/deconvolution_mrs_noRotation.py semantics: rectangle-gridded
    MRSBlurred per λ plane, quadratic criterion, lcg) — all planes batched
    into one vmapped program and solved in a single CG."""
    from .core.fft import ir2fr
    from .models.blind2d import DeconvCube, MRSBlurred, MRSBlurredRectangle
    from .simulation.synthetic import make_setup
    from .solvers.criterion import QuadCriterion_MRS
    from .utils import metrics

    npix, n_lambda = args.npix, args.n_lambda
    os.makedirs(args.output_dir, exist_ok=True)
    setup = make_setup(
        im_size=npix, n_lambda=n_lambda, n_channels=1, n_pointings=args.pointings
    )
    sotf_stack = np.stack(
        [ir2fr(p, setup["im_shape"]) for p in setup["spsf"][:n_lambda]]
    )
    cls = MRSBlurredRectangle if args.rectangle else MRSBlurred
    base = cls(
        sotf_stack[0],
        setup["alpha_axis"],
        setup["beta_axis"],
        setup["instrs"][0],
        setup["step_degree"],
        setup["pointings"][0],
    )
    model = DeconvCube(base, sotf_stack)

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:npix, 0:npix]
    img = np.zeros(setup["im_shape"], np.float32)
    for _ in range(6):
        cx, cy = rng.integers(10, npix - 10, 2)
        s = rng.uniform(2, 6)
        img += rng.uniform(0.5, 2) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)
        )
    spectra = 0.5 + rng.random(n_lambda).cumsum() / n_lambda
    truth = spectra[:, None, None].astype(np.float32) * img
    y = np.asarray(model.forward(truth))

    t0 = time.perf_counter()
    crit = QuadCriterion_MRS(1.0, y, model, args.hyper_parameter,
                             gradient="separated")
    res = crit.run_method("lcg", maximum_iterations=args.niter)
    dt = time.perf_counter() - t0

    np.save(os.path.join(args.output_dir, "deconv_cube_x.npy"), res.x)
    _emit({
        "n_lambda": n_lambda,
        "niter": int(res.n_iter),
        "seconds": dt,
        "iters_per_s": res.n_iter / max(dt, 1e-9),
        "psnr": metrics.psnr(truth, res.x.reshape(model.ishape)),
    })


def deconv2d(args):
    """Single-wavelength 2-D MRS deconvolution (the minimum end-to-end slice,
    reference scripts/deconvolution_mrs_single_wavelength.py)."""
    from .core.fft import ir2fr
    from .models.blind2d import MRSBlurred, MRSBlurredRectangle
    from .simulation.synthetic import make_setup
    from .solvers.criterion import QuadCriterion_MRS_2D
    from .utils import metrics

    npix = args.npix
    os.makedirs(args.output_dir, exist_ok=True)
    setup = make_setup(im_size=npix, n_lambda=8, n_channels=1, n_pointings=4)
    psf0 = setup["spsf"][0]
    sotf = ir2fr(psf0, setup["im_shape"])
    cls = MRSBlurredRectangle if args.rectangle else MRSBlurred
    model = cls(
        sotf,
        setup["alpha_axis"],
        setup["beta_axis"],
        setup["instrs"][0],
        setup["step_degree"],
        setup["pointings"][0],
    )
    rng = np.random.default_rng(1)
    truth = np.zeros(setup["im_shape"], np.float32)
    for _ in range(6):
        cx, cy = rng.integers(10, npix - 10, 2)
        s = rng.uniform(2, 6)
        yy, xx = np.mgrid[0:npix, 0:npix]
        truth += rng.uniform(0.5, 2) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    y = np.asarray(model.forward(truth))

    t0 = time.perf_counter()
    crit = QuadCriterion_MRS_2D(1.0, y, model, args.hyper_parameter)
    res = crit.run_method("lcg", maximum_iterations=args.niter)
    dt = time.perf_counter() - t0

    np.save(os.path.join(args.output_dir, "deconv2d_x.npy"), res.x)
    _emit({
        "niter": int(res.n_iter),
        "seconds": dt,
        "psnr": metrics.psnr(truth, res.x),
    })


def allband(args):
    """All-band fusion with on-device NMF templates (BASELINE config 5):
    simulate 12-band data, co-add a dirty hypercube, learn NMF templates on
    device, fuse all bands with them, report metrics + per-stage timings
    (reference chain: notebooks/nmf_orion_allband.ipynb →
    scripts/main_fusion.py:215-273)."""
    from .pipeline import run_allband_simulated

    _emit(run_allband_simulated(
        npix=args.npix,
        bands=args.bands.split(",") if args.bands else None,
        n_pointings=args.pointings,
        n_templates=args.n_templates,
        mu=args.hyper_parameter,
        niter=args.niter,
        method=args.method,
        nmf_iter=args.nmf_iter,
        output_dir=args.output_dir,
        window_local=args.window_local,
        lambda_subsample=args.lambda_subsample,
    ))


def metadata(args):
    """Header-metadata fix-ups of the real-data correction chain.

    Parametrized equivalents of the reference one-off scripts:
    targ-coords ≙ correct_RA_DEC_corrected_slices.py, rotation ≙
    correct_rotation_slices.py, swap-slits ≙
    swipe_filter_corrected_mrs_data.py, rank-target ≙
    compare_fits_target_regarding_position.py."""
    from .preprocessing import metadata as md

    operation, raw_dir = args.operation, args.raw_dir
    slice_dirs = args.slice_dirs or []
    if operation == "targ-coords":
        if not raw_dir or not slice_dirs:
            raise UsageError("targ-coords needs --raw-dir and --slice-dir")
        n = md.propagate_target_coords(raw_dir, list(slice_dirs),
                                       verbose=args.verbose)
        _emit({"operation": operation, "files_updated": n})
    elif operation == "rotation":
        if not raw_dir or len(slice_dirs) != 1:
            raise UsageError("rotation needs --raw-dir and ONE --slice-dir")
        n = md.propagate_rotation(raw_dir, slice_dirs[0], verbose=args.verbose)
        _emit({"operation": operation, "files_updated": n})
    elif operation == "swap-slits":
        if len(slice_dirs) != 1:
            raise UsageError("swap-slits needs ONE --slice-dir")
        n = md.swap_slit_blocks_in_files(
            slice_dirs[0], match=args.match, n_slit=args.n_slit,
            block_width=args.block_width, verbose=args.verbose)
        _emit({"operation": operation, "files_updated": n})
    else:  # rank-target
        if not raw_dir or args.ref_ra is None or args.ref_dec is None:
            raise UsageError("rank-target needs --raw-dir, --ref-ra, --ref-dec")
        paths = [os.path.join(raw_dir, f) for f in sorted(os.listdir(raw_dir))
                 if f.endswith(".fits")]
        ranked = md.rank_files_by_target_distance(paths, args.ref_ra, args.ref_dec)
        _emit({"operation": operation, "ranked": [
            {"path": p, "distance_deg": d} for p, d in ranked]})


def make_cube(args):
    """Mix abundance maps with spectral templates into a hyperspectral cube
    (reference scripts/make_cube_from_maps.py: model.mapsToCube on saved
    res_x maps; the mixing itself is cube[λ]=Σ_m maps[m]·templates[m,λ])."""
    from .core.lmm import lmm_maps2cube

    maps = np.load(args.maps_path)
    templates = np.load(args.templates_path)
    if templates.ndim == 1:
        templates = templates[np.newaxis, ...]
    if maps.ndim == 2:
        maps = maps[np.newaxis, ...]
    if templates.ndim != 2 or maps.ndim != 3:
        raise UsageError(
            f"expected maps (m, Nα, Nβ) and templates (m, λ); got "
            f"{maps.shape} and {templates.shape}")
    if maps.shape[0] != templates.shape[0]:
        raise UsageError(
            f"maps ({maps.shape[0]}) and templates ({templates.shape[0]}) "
            "disagree on the number of components")
    cube = np.asarray(lmm_maps2cube(maps, templates))
    output = args.output
    if output.endswith(".fits"):
        from .preprocessing import fits_write

        header = {}
        if args.wavel_path:
            wavel = np.load(args.wavel_path)
            header = {"CRVAL3": float(wavel[0]), "CRPIX3": 1.0,
                      "CDELT3": float(wavel[1] - wavel[0]) if len(wavel) > 1 else 1.0,
                      "CUNIT3": "um", "CTYPE3": "WAVE"}
        fits_write(output, cube.astype(np.float32), header=header)
    else:
        np.save(output, cube)
    _emit({"cube_shape": list(cube.shape), "output": output})


def compare_flux(args):
    """Mean-flux comparison of a fused cube vs a real data cube, per λ-slice
    (reference scripts/compare_mean_flux_fusion_vs_real_data.py: non-zero
    mean per slice, optional polygon-region spectrum, λ median filter)."""
    from .preprocessing import median_filter_slices
    from .utils import metrics

    fused = np.load(args.fusion_cube)
    if args.mask:
        fused = fused * np.load(args.mask)[np.newaxis, ...]
    if args.real_cube.endswith(".npy"):
        real = np.load(args.real_cube)
    else:
        from .preprocessing import fits_open

        hdus = fits_open(args.real_cube)
        real = np.asarray(next(h.data for h in hdus if h.data is not None
                               and np.ndim(h.data) == 3), np.float64)
    real = np.nan_to_num(real)
    if args.median_size:
        real = median_filter_slices(real.reshape(real.shape[0], -1),
                                    size=args.median_size).reshape(real.shape)
    out = {
        "mean_flux_fusion": metrics.nonzero_mean_per_slice(fused),
        "mean_flux_real": metrics.nonzero_mean_per_slice(real),
    }
    if args.region:
        poly = [tuple(map(float, p.split(","))) for p in args.region.split(";")]
        out["region_spectrum"] = metrics.region_mean_spectrum(fused, poly)
    if args.output:
        np.savez(args.output, **out)
    _emit({k: [float(v[0]), float(v[-1])] for k, v in out.items()}
          | {"n_lambda": int(fused.shape[0])})


REHEARSE_DEFAULT_BAND = "4a"


def rehearse(args):
    """The production real-data flow, chained end-to-end in ONE command:

    synthetic stage-2 cal.fits → distortion correction (Shepard, slit
    reorder) → median λ-filter → fusion → flux comparison — the rehearsal
    of /root/reference's correction_mrs_data.py → filter_corrected_mrs_data
    .py → main_fusion.py → compare_mean_flux chain, with the stage-2 inputs
    and WCS synthesized (neither real MRS data nor the jwst package exist
    in this image); everything downstream of the loader is production code.
    """
    from .pipeline import run_rehearsal

    band = args.band
    geo = {}
    if args.header is not None:
        from .preprocessing.metadata import header_geometry

        parsed = header_geometry(args.header)
        geo = {k: parsed[k] for k in ("targ_ra", "targ_dec", "pa_v3")}
        if band is None and parsed["band"]:
            band = parsed["band"]
    if band is None:
        band = REHEARSE_DEFAULT_BAND
    for key in ("targ_ra", "targ_dec", "pa_v3"):
        if getattr(args, key) is not None:
            geo[key] = getattr(args, key)

    _emit(run_rehearsal(
        args.work_dir, band=band, n_pointings=args.pointings, npix=args.npix,
        step_arcsec=args.step, lambda_subsample=args.lambda_subsample,
        mu=args.mu, niter=args.niter, method=args.method,
        noise_rms=args.noise_rms, **geo,
    ))


def gen_psf(args):
    """Generate a monochromatic JWST diffraction PSF stack (webbpsf-free).

    Native physical-optics replacement for the reference's
    `scripts/webbpsf_generation.py` (segmented-pupil matrix Fourier
    transform; see `utils/jwst_psf.py`). Writes [Nλ, npix, npix] float32.
    `--opd` loads a wavefront map (resampled to the pupil grid) so
    measured-OPD PSFs match webbpsf's
    (notebooks/webbpsf_generation.ipynb capability).
    """
    import jax

    from .instrument.wavelength_mrs import get_mrs_wavelength
    from .utils.jwst_psf import (
        load_opd, psf_stack, psf_stack_device, recorded_opd)

    wavels = (np.load(args.wavel_axis) if args.wavel_axis is not None
              else get_mrs_wavelength(args.band))
    opd = args.opd
    if opd == "commissioning":
        opd = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "instrument", "data",
                           "jwst_opd_commissioning.json")
    if opd and opd.endswith(".json"):
        opd_map = recorded_opd(opd, args.n_pupil)
    elif opd:
        opd_map = load_opd(opd, args.n_pupil, unit=args.opd_unit)
    else:
        opd_map = None
    t0 = time.time()
    kw = dict(npix=args.npix, oversample=args.oversample,
              n_pupil=args.n_pupil, opd=opd_map)
    if jax.default_backend() != "cpu":
        # accelerator: kernels built in-graph, one dispatch per λ-chunk
        stack = psf_stack_device(wavels, args.pixelscale, **kw)
    else:
        stack = psf_stack(wavels, args.pixelscale, **kw)
    np.save(args.output, stack)
    _emit({
        "n_lambda": int(stack.shape[0]), "npix": args.npix,
        "pixelscale": args.pixelscale, "seconds": round(time.time() - t0, 2),
        "opd_rms_nm": (round(float(np.sqrt(np.mean(opd_map**2))) * 1e9, 3)
                       if opd_map is not None else 0.0),
        "output": args.output,
    })


def warmup(args):
    """Prime the persistent compile cache for the flagship programs.

    A cold first run pays the full XLA compile of the forward/adjoint
    programs.  Running `warmup` once per environment moves that cost out of
    production runs: later processes load the compiled executables from the
    cache (`--cache-dir`, else `JAX_COMPILATION_CACHE_DIR`, else
    `.surfh_cache/jax` in the checkout).  Prints per-program compile
    seconds (cache hits show up as ~0)."""
    import jax
    import jax.numpy as jnp

    from .simulation.flagship import make_flagship_model
    from .utils.cache import enable_compile_cache

    if args.cache_dir:
        jax.config.update("jax_compilation_cache_dir", args.cache_dir)
        cache_dir = args.cache_dir
    else:
        cache_dir = enable_compile_cache()
    report = {"cache_dir": cache_dir, "backend": jax.default_backend()}
    t0 = time.time()
    model, setup = make_flagship_model(
        bands=[b.strip() for b in args.bands.split(",")] if args.bands else None,
    )
    report["t_build_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    tables = model.device_tables()
    jax.block_until_ready(jax.tree_util.tree_leaves(tables))
    report["t_tables_s"] = round(time.time() - t0, 1)
    app_args = (tables,) if model.window_local else ()
    fwd_fn = model._forward_fn_tabled if model.window_local else model._forward_fn
    adj_fn = model._adjoint_fn_tabled if model.window_local else model.adjoint_fn

    want = {p.strip() for p in args.programs.split(",")}
    x_spec = jax.ShapeDtypeStruct(model.ishape, jnp.float32)
    y_spec = jax.ShapeDtypeStruct(model.oshape, jnp.float32)
    if "fwd" in want:
        t0 = time.time()
        jax.jit(fwd_fn).lower(x_spec, *app_args).compile()
        report["t_compile_fwd_s"] = round(time.time() - t0, 1)
    if "adj" in want:
        t0 = time.time()
        jax.jit(adj_fn).lower(y_spec, *app_args).compile()
        report["t_compile_adj_s"] = round(time.time() - t0, 1)
    if "normal" in want and model.window_local:
        t0 = time.time()
        jax.jit(model._normal_fn_tabled).lower(x_spec, *app_args).compile()
        report["t_compile_normal_s"] = round(time.time() - t0, 1)
    _emit(report)


def info(args):
    """Print device/backend information."""
    import jax

    _emit({
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
    })


# --------------------------------------------------------------------------
# parser
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m surfh_tpu.cli",
        description="surfh_tpu — JWST MRS super-resolution and fusion in JAX. "
                    "Set SURFH_CPU=1 to force the CPU backend (e.g. for "
                    "local dry runs).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    sub = ap.add_subparsers(dest="command", required=True, metavar="COMMAND")

    def command(name, fn):
        p = sub.add_parser(name, help=fn.__doc__.split("\n")[0],
                           description=fn.__doc__,
                           formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        p.set_defaults(func=fn)
        return p

    def output_dir(p):
        p.add_argument("--output-dir", "-o", default="./surfh_results")

    def rectangle(p, help_):
        p.add_argument("--rectangle", dest="rectangle", action="store_true",
                       default=True, help=help_)
        p.add_argument("--rotated", dest="rectangle", action="store_false")

    methods = ["lcg", "mmmg"]

    p = command("fusion", fusion)
    p.add_argument("--fusion-data", "-fd", type=_existing_path, default=None,
                   help="Directory with templates.npy / wavel_axis.npy / psfs_*.npy and slice data (real-data mode).")
    p.add_argument("--simulated", action="store_true", help="Run a fully simulated fusion (no data files needed).")
    p.add_argument("--npix", "-np", type=int, default=81, help="Spatial grid size.")
    p.add_argument("--n-lambda", type=int, default=60, help="Cube λ samples (simulated mode).")
    p.add_argument("--channels", "-nc", type=int, default=2, help="Number of bands (simulated mode).")
    p.add_argument("--pointings", type=int, default=2, help="Dither pointings (simulated mode).")
    p.add_argument("--hyper-parameter", "-hp", type=float, default=5e3, help="Regularization µ.")
    p.add_argument("--niter", "-ni", type=int, default=50)
    p.add_argument("--n-templates", "-nt", type=int, default=4)
    p.add_argument("--scale-data", "-sd", action="store_true", help="Apply Jy/SR → Jy flux normalization (real data).")
    p.add_argument("--method", "-m", default="lcg", choices=methods)
    p.add_argument("--noise-snr", type=float, default=0.0, help="Add white noise at this SNR (dB) to simulated data.")
    p.add_argument("--sharded", action="store_true", help="Shard channels over the device mesh.")
    p.add_argument("--checkpoint-every", type=int, default=0, help="Checkpoint the solver state every N iterations.")
    output_dir(p)
    p.add_argument("--verbose", "-v", action="store_true")

    p = command("deconv-cube", deconv_cube)
    p.add_argument("--npix", "-np", type=int, default=81)
    p.add_argument("--n-lambda", "-nl", type=int, default=24, help="λ planes in the deconvolved stack.")
    p.add_argument("--hyper-parameter", "-hp", type=float, default=5.0)
    p.add_argument("--niter", "-ni", type=int, default=100)
    p.add_argument("--pointings", type=int, default=2, help="Dither pointings (the reference run keeps [P1, P3]).")
    rectangle(p, "Rectangle (no-rotation) or rotated-FOV gridding.")
    output_dir(p)

    p = command("deconv2d", deconv2d)
    p.add_argument("--npix", "-np", type=int, default=81)
    p.add_argument("--hyper-parameter", "-hp", type=float, default=500.0)
    p.add_argument("--niter", "-ni", type=int, default=200)
    rectangle(p, "Rectangle (no-rotation) or rotated-FOV PSF variant.")
    output_dir(p)

    p = command("allband", allband)
    p.add_argument("--npix", "-np", type=int, default=61)
    p.add_argument("--bands", "-b", default=None, help="Comma-separated band subset (default: all 12).")
    p.add_argument("--pointings", type=int, default=4)
    p.add_argument("--n-templates", "-nt", type=int, default=4)
    p.add_argument("--hyper-parameter", "-hp", type=float, default=5e3)
    p.add_argument("--niter", "-ni", type=int, default=50)
    p.add_argument("--nmf-iter", type=int, default=300, help="On-device NMF multiplicative-update iterations.")
    p.add_argument("--method", "-m", default="lcg", choices=methods)
    p.add_argument("--window-local", action="store_true", help="Tables-as-arguments mode (flagship-scale compiles).")
    p.add_argument("--lambda-subsample", type=int, default=1)
    output_dir(p)

    p = command("metadata", metadata)
    p.add_argument("operation", choices=["targ-coords", "rotation", "swap-slits", "rank-target"])
    p.add_argument("--raw-dir", type=_existing_path, default=None, help="Raw-exposure directory (source of RA_V1/DEC_V1/PA_V3).")
    p.add_argument("--slice-dir", dest="slice_dirs", action="append", type=_existing_path,
                   help="Corrected/filtered slice directory (repeatable).")
    p.add_argument("--match", default="ch2", help="Filename substring filter (swap-slits).")
    p.add_argument("--n-slit", type=int, default=17)
    p.add_argument("--block-width", type=int, default=24)
    p.add_argument("--ref-ra", type=float, default=None, help="Target RA (rank-target).")
    p.add_argument("--ref-dec", type=float, default=None, help="Target DEC (rank-target).")
    p.add_argument("--verbose", "-v", action="store_true")

    p = command("make-cube", make_cube)
    p.add_argument("--maps", dest="maps_path", required=True, type=_existing_path,
                   help=".npy abundance maps (m, Nα, Nβ) — e.g. a fusion res_x.npy.")
    p.add_argument("--templates", dest="templates_path", required=True, type=_existing_path,
                   help=".npy spectral templates (m, λ).")
    p.add_argument("--wavel-axis", dest="wavel_path", type=_existing_path, default=None,
                   help=".npy λ axis (for FITS WCS headers).")
    p.add_argument("--output", "-o", required=True,
                   help="Output cube path (.npy, or .fits with λ WCS when --wavel-axis is given).")

    p = command("compare-flux", compare_flux)
    p.add_argument("--fusion-cube", required=True, type=_existing_path, help=".npy fused cube (λ, y, x).")
    p.add_argument("--real-cube", required=True, type=_existing_path,
                   help=".npy or FITS s3d real cube to compare against.")
    p.add_argument("--mask", type=_existing_path, default=None,
                   help="Optional .npy binary mask applied to the fused cube.")
    p.add_argument("--median-size", type=int, default=15, help="λ median filter on the real cube (0 = off).")
    p.add_argument("--region", default=None, help="Polygon vertices 'r1,c1;r2,c2;...' for a region spectrum.")
    p.add_argument("--output", "-o", default=None, help="Save curves to this .npz.")

    p = command("rehearse", rehearse)
    p.add_argument("--work-dir", "-w", default="./surfh_rehearsal",
                   help="Working directory (raw/, Filtered_slices/, out/ created inside).")
    p.add_argument("--band", "-b", default=None,
                   help=f"MRS band (default: from --header, else {REHEARSE_DEFAULT_BAND}).")
    p.add_argument("--pointings", type=int, default=2)
    p.add_argument("--npix", "-np", type=int, default=101)
    p.add_argument("--step", type=float, default=0.1, help="Grid step (arcsec).")
    p.add_argument("--lambda-subsample", type=int, default=4)
    p.add_argument("--hyper-parameter", "-hp", dest="mu", type=float, default=1.0)
    p.add_argument("--niter", "-ni", type=int, default=60)
    p.add_argument("--method", "-m", default="lcg", choices=methods)
    p.add_argument("--noise-rms", type=float, default=0.0,
                   help="Gaussian noise added to the synthetic detector frames.")
    p.add_argument("--header", default=None, type=_existing_path,
                   help="Seed TARG_RA/TARG_DEC/PA_V3 (and the band, unless --band is given "
                        "explicitly) from a real stage-2 FITS file or header card dump "
                        "instead of synthetic defaults.")
    p.add_argument("--targ-ra", type=float, default=None, help="Target RA (deg); overrides --header.")
    p.add_argument("--targ-dec", type=float, default=None, help="Target Dec (deg); overrides --header.")
    p.add_argument("--pa-v3", type=float, default=None, help="Telescope V3 position angle (deg); overrides --header.")

    p = command("gen-psf", gen_psf)
    p.add_argument("--wavel-axis", "-w", type=_existing_path, default=None,
                   help="λ-axis .npy (µm). Defaults to the band's detector table.")
    p.add_argument("--band", "-b", default="1c", help="MRS band for the default λ axis.")
    p.add_argument("--pixelscale", type=float, default=0.025, help="Arcsec/pixel.")
    p.add_argument("--npix", type=int, default=501, help="Output grid size.")
    p.add_argument("--oversample", type=int, default=1)
    p.add_argument("--n-pupil", type=int, default=256, help="Pupil grid samples.")
    p.add_argument("--opd", default=None,
                   help="Wavefront/OPD map injected as a pupil phase screen (the "
                        "measured-OPD capability of webbpsf): a .fits/.npy map, a "
                        ".json recorded decomposition (utils.jwst_psf.recorded_opd), "
                        "or 'commissioning' for the bundled in-flight-level fixture.")
    p.add_argument("--opd-unit", default="m", choices=["m", "um", "nm"], help="OPD map unit.")
    p.add_argument("--output", "-o", default="psf.npy")

    p = command("warmup", warmup)
    p.add_argument("--bands", "-b", default=None, help="Comma-separated band list (default: all 12).")
    p.add_argument("--cache-dir", default=None,
                   help="Persistent XLA compile cache to prime (default: "
                        "$JAX_COMPILATION_CACHE_DIR, else .surfh_cache/jax).")
    p.add_argument("--programs", default="fwd,adj", help="Comma-set of programs to compile: fwd,adj,normal.")

    command("info", info)
    return ap


def main(argv=None) -> int:
    """Run one command; `argv` defaults to `sys.argv[1:]`."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if os.environ.get("SURFH_CPU"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    try:
        args.func(args)
    except UsageError as e:
        parser.error(f"{args.command}: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
