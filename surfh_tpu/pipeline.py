"""Real-data fusion pipeline: corrected-slice FITS directory → reconstruction.

Behavioural reference: scripts/main_fusion.py (load_data :30-62,
initialize_parameters :65-77, load_simulation_data :79-101,
create_instruments :103-134, create_model :136-157,
reconstruction_method :162-207).

Expected directory layout (same roles as the reference's fusion dir):

    fusion_dir/
      Templates/templates.npy        # [n_tpl, Nλ] (NMF output)
      Templates/wavel_axis.npy       # [Nλ] global cube λ axis
      PSF/psf.npy                    # [Nλ, h, w] monochromatic PSFs
      Filtered_slices/*.fits         # corrected+filtered slices, one file
                                     # per (band, pointing); headers carry
                                     # PA_V3 / TARG_RA / TARG_DEC / BAND

Slice files store [Nλ_det, n_slit·Nα_det] (the layout written by
scripts/correct_mrs_data.py, matching the reference writer).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from .core.fft import ir2fr
from .instrument.geometry import Coord, CoordList
from .instrument.ifu import IFU
from .instrument.geometry import FOV
from .instrument.realmiri import _CHANNEL_SPECS, GRATING_RES
from .instrument.spectral import SpectralBlur
from .instrument.wavelength_mrs import get_mrs_wavelength
from .preprocessing.fits_io import fits_open

STEP_ARCSEC = 0.025


def crop_psf_stack(spsf: np.ndarray, npix: int) -> np.ndarray:
    """Center-crop a monochromatic PSF stack [Nλ, h, w] to the sky grid.

    Precomputed webbpsf stacks are generated at a fixed pixel grid (e.g.
    `psfs_pixscale0.025_npix_501_...npy`) and must be windowed to the run's
    grid; uses the reference's centering convention (`simulation_data.py:
    96-133`: window start idx-(N//2) for odd N, idx-(N/2-1) for even,
    clamped to the stack), so cropped PSFs match the reference bit-for-bit.
    """
    spsf = np.asarray(spsf)
    out = spsf
    for ax in (1, 2):
        size = out.shape[ax]
        if size <= npix:
            continue
        idx = size // 2
        stepidx = npix // 2 if npix % 2 else npix // 2 - 1
        start = min(max(idx - stepidx, 0), size - npix)
        sl = [slice(None)] * out.ndim
        sl[ax] = slice(start, start + npix)
        out = out[tuple(sl)]
    return out


def load_corrected_data(slices_dir: str, bands: Sequence[str]) -> Dict:
    """Load per-band corrected slices (reference load_data, main_fusion.py:30-62)."""
    out = {"data": {b: [] for b in bands}, "target": {b: [] for b in bands}, "rotation": {b: 0.0 for b in bands}}
    for fname in sorted(os.listdir(slices_dir)):
        if not fname.endswith(".fits"):
            continue
        for band in bands:
            if band not in fname.lower():
                continue
            hdus = fits_open(os.path.join(slices_dir, fname))
            hdr = hdus[0].header
            data = np.asarray(hdus[0].data)
            n_lam = len(get_mrs_wavelength(band))
            n_slit = _CHANNEL_SPECS[int(band[0])][0]
            ndata = data.reshape(n_lam, n_slit, -1).transpose(1, 0, 2)
            out["data"][band].append(ndata)
            out["target"][band].append((float(hdr["TARG_RA"]), float(hdr["TARG_DEC"])))
            out["rotation"][band] = float(hdr["PA_V3"])
    return out


def create_instruments(data_dict: Dict, bands: Sequence[str]) -> Dict[str, IFU]:
    """Degree-unit IFUs with the observation position angle
    (reference create_instruments, main_fusion.py:103-134)."""
    instruments = {}
    for band in bands:
        chan = int(band[0])
        n_slit, pix, aw, bw, _ = _CHANNEL_SPECS[chan]
        res = GRATING_RES[(chan - 1) * 3 + "abc".index(band[1])]
        instruments[band] = IFU(
            fov=FOV(aw / 3600, bw / 3600, origin=Coord(0, 0), angle=-data_dict["rotation"][band]),
            det_pix_size=pix,
            n_slit=n_slit,
            w_blur=SpectralBlur(res),
            pce=None,
            wavel_axis=get_mrs_wavelength(band),
            name=band.upper(),
        )
    return instruments


def create_model(
    sotf,
    templates,
    alpha_axis,
    beta_axis,
    wavel_axis,
    instruments: Dict[str, IFU],
    step_degree: float,
    data_dict: Dict,
    ref_band: Optional[str] = None,
    dtype=None,
):
    """Flagship model anchored at the observed pointings
    (reference create_model, main_fusion.py:136-157)."""
    import jax.numpy as jnp

    from .models.spectro import SpectroSigRLSCT

    bands = list(instruments.keys())
    if ref_band is None:
        ref_band = bands[0]
    main = Coord(0, 0)
    pointings = []
    for band in bands:
        pts = [main + Coord(ra, dec) for ra, dec in data_dict["target"][band]]
        pointings.append(CoordList(pts).pix(step_degree))
    ref_idx = min(2, len(data_dict["target"][ref_band]) - 1)
    ra0, dec0 = data_dict["target"][ref_band][ref_idx]
    return SpectroSigRLSCT(
        sotf=sotf,
        templates=templates,
        alpha_axis=np.asarray(alpha_axis) + ra0,
        beta_axis=np.asarray(beta_axis) + dec0,
        wavelength_axis=np.asarray(wavel_axis),
        instrs=[instruments[b] for b in bands],
        step_degree=step_degree,
        pointings=pointings,
        dtype=dtype if dtype is not None else jnp.float32,
    )


def assemble_data_vector(model, data_dict: Dict, bands: Sequence[str]) -> np.ndarray:
    """Per-band [P, S, λ, α] blocks → the model's flat data layout."""
    blocks = []
    for c, band in enumerate(bands):
        stack = np.stack(data_dict["data"][band])  # [P, S, λ, α]
        want = model.instrs_oshape[c]
        if stack.shape != want:
            raise ValueError(f"band {band}: data shape {stack.shape} != model {want}")
        blocks.append(np.nan_to_num(stack).ravel())
    return np.concatenate(blocks)


def run_real_fusion(
    fusion_dir: str,
    bands: Sequence[str],
    npix: int = 501,
    mu: float = 5e3,
    niter: int = 50,
    method: str = "lcg",
    scale_data: bool = False,
    output_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    step_arcsec: float = STEP_ARCSEC,
):
    """End-to-end real-data fusion (the reference's flagship entry point).

    `step_arcsec` is the super-resolution grid step (the reference hardcodes
    0.025″, main_fusion.py:74)."""
    from .solvers.checkpoint import run_checkpointed
    from .solvers.criterion import QuadCriterion_MRS

    step_degree = step_arcsec / 3600.0
    tpl_dir = os.path.join(fusion_dir, "Templates")
    templates = np.load(os.path.join(tpl_dir, "templates.npy"))
    wavel_axis = np.load(os.path.join(tpl_dir, "wavel_axis.npy"))
    spsf = crop_psf_stack(
        np.load(os.path.join(fusion_dir, "PSF", "psf.npy")), npix
    )

    alpha_axis = np.arange(npix) * step_degree
    alpha_axis -= np.mean(alpha_axis)
    beta_axis = alpha_axis.copy()
    sotf = ir2fr(spsf, (npix, npix))

    data_dict = load_corrected_data(os.path.join(fusion_dir, "Filtered_slices"), bands)
    instruments = create_instruments(data_dict, bands)
    model = create_model(
        sotf, templates, alpha_axis, beta_axis, wavel_axis, instruments,
        step_degree, data_dict,
    )
    y = assemble_data_vector(model, data_dict, bands)
    if scale_data:
        y = model.real_data_janskySR_to_jansky(y)

    crit = QuadCriterion_MRS(1.0, y, model, mu, printing=True)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    ck = os.path.join(output_dir, "solver_state.npz") if output_dir else None
    res = run_checkpointed(
        crit, method=method, niter=niter,
        checkpoint_path=ck, checkpoint_every=checkpoint_every,
    )
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        np.save(os.path.join(output_dir, "res_x.npy"), res.x)
        np.save(os.path.join(output_dir, "res_cube.npy"), np.asarray(model.mapsToCube(res.x)))
        np.save(os.path.join(output_dir, "criterion.npy"), res.grad_norm)
    return res, model


def run_rehearsal(
    work_dir: str,
    band: str = "4a",
    n_pointings: int = 2,
    npix: int = 61,
    step_arcsec: float = 0.1,
    lambda_subsample: int = 4,
    n_tpl: int = 2,
    mu: float = 10.0,
    niter: int = 30,
    method: str = "lcg",
    n_rows: Optional[int] = None,
    noise_rms: float = 0.0,
    targ_ra: float = 83.83,
    targ_dec: float = -5.42,
    pa_v3: float = 0.0,
) -> Dict:
    """The production real-data flow as ONE chained run:

      synthetic stage-2 cal.fits → distortion correction (Shepard, slit
      reorder) → median λ-filter → corrected-slice FITS → fusion →
      flux comparison

    mirroring /root/reference/scripts/correction_mrs_data.py:92-199 →
    filter_corrected_mrs_data.py:34 → main_fusion.py:215-273 →
    compare_mean_flux_fusion_vs_real_data.py.  The stage-2 inputs and their
    WCS are synthesized (`simulation.stage2`) since neither real MRS data
    nor the `jwst` package exist in this image; every stage downstream of
    the loader is the production code path.

    Returns a report dict with per-stage timings, the fusion residual, and
    the fused-vs-data mean-flux comparison.
    """
    import time as _time

    from .instrument import miri
    from .preprocessing.correction_driver import (
        correct_file,
        corrected_to_fits,
    )
    from .preprocessing.distortion import median_filter_slices
    from .simulation.stage2 import stage2_wcs_loader, write_synthetic_stage2
    from .utils import metrics
    from .utils.psf import gaussian_psf

    report: Dict = {"band": band, "n_pointings": n_pointings, "npix": npix,
                    "targ_ra": targ_ra, "targ_dec": targ_dec, "pa_v3": pa_v3}
    lam_table = get_mrs_wavelength(band)
    # cube λ axis: the band table subsampled, EXTENDED by the spectral-blur
    # margin on both ends (the flagship cube axis is the all-band union, so
    # each band's window has neighbors to blur into; a lone band needs the
    # margin explicitly or the wpsf support truncates at the table edges)
    dstep = float(np.median(np.diff(lam_table))) * lambda_subsample
    margin = np.arange(1, int(np.ceil(0.1 / dstep)) + 1) * dstep
    wavel_axis = np.concatenate([
        lam_table[0] - margin[::-1],
        np.asarray(lam_table[::lambda_subsample], np.float64),
        lam_table[-1] + margin,
    ])

    # 1. synthetic stage-2 observations: one file per dither pointing
    t0 = _time.perf_counter()
    raw_dir = os.path.join(work_dir, "raw")
    # defaults: Orion bar, like the reference data; override with the
    # geometry of a real header (tests seed PA_V3/TARG_RA/TARG_DEC from
    # the vendored PDRs4All cal-header fixture)
    dith = np.asarray(miri.dithering)[:n_pointings] / 3600.0
    # α sampling density of the detector strips ≈ the corrected grid's
    # per-slit α count, so the Shepard regrid has a sample within its
    # pixel cutoff of every output cell (like the real detector)
    from .instrument.geometry import get_srf
    from .instrument.realmiri import _CHANNEL_SPECS as _SPECS

    _n_slit, det_pix, aw, _bw, _rot = _SPECS[int(band[0])]
    srf = get_srf([det_pix], step_arcsec)[0]
    strip_w = int(np.ceil(aw / step_arcsec / srf)) + 1
    raw_files = []
    for p in range(n_pointings):
        path = os.path.join(
            raw_dir, f"obs1_ch{band}_dither{p + 1}_cal.fits"
        )
        write_synthetic_stage2(
            path, band,
            targ_ra + float(dith[p][0]), targ_dec + float(dith[p][1]),
            pa_v3=pa_v3, n_rows=n_rows, strip_w=strip_w,
            scene_ra=targ_ra, scene_dec=targ_dec,  # fixed sky, moving FOV
            noise_rms=noise_rms, seed=p,
        )
        raw_files.append(path)
    report["t_stage2_s"] = round(_time.perf_counter() - t0, 2)
    report["n_raw_files"] = len(raw_files)

    # 2+3. distortion correction + median λ-filter → Filtered_slices/
    t0 = _time.perf_counter()
    filt_dir = os.path.join(work_dir, "Filtered_slices")
    os.makedirs(filt_dir, exist_ok=True)
    for p, path in enumerate(raw_files):
        corrected, ifu, ra, dec = correct_file(
            path, f"ch{band}", npix, wavel_axis, mode=0,
            wcs_loader=stage2_wcs_loader, step_arcsec=step_arcsec,
        )
        filtered = median_filter_slices(corrected, size=11)
        corrected_to_fits(
            os.path.join(filt_dir, f"{band}_dither{p + 1}_corrected.fits"),
            filtered, ifu, ra, dec,
        )
    report["t_correct_s"] = round(_time.perf_counter() - t0, 2)

    # 4. fusion assets: templates learned FROM THE CORRECTED DATA (the
    # reference's NMF stage learns from the reconstructed data cube,
    # notebooks/nmf_orion_allband.ipynb): mean data spectrum + a flat
    # continuum span the LMM's spectral space; λ axis; PSF stack
    tpl_dir = os.path.join(work_dir, "Templates")
    os.makedirs(tpl_dir, exist_ok=True)
    dd0 = load_corrected_data(filt_dir, [band])
    arr = np.stack(dd0["data"][band])  # [P, S, λ_det, α]
    with np.errstate(invalid="ignore"):
        spec_det = np.nanmean(np.where(arr > 0, arr, np.nan), axis=(0, 1, 3))
    spec_det = np.nan_to_num(spec_det, nan=float(np.nanmedian(spec_det)))
    spec = np.interp(wavel_axis, np.asarray(lam_table, np.float64), spec_det)
    spec = spec / max(spec.mean(), 1e-30)
    templates = np.stack(
        [spec] + [np.ones_like(spec)] * max(n_tpl - 1, 1)
    )[:n_tpl]
    if n_tpl > 2:
        lam01 = (wavel_axis - wavel_axis[0]) / max(
            wavel_axis[-1] - wavel_axis[0], 1e-9
        )
        for m in range(2, n_tpl):
            templates[m] = 0.5 + lam01 ** m
    np.save(os.path.join(tpl_dir, "templates.npy"), templates)
    np.save(os.path.join(tpl_dir, "wavel_axis.npy"), wavel_axis)
    psf_dir = os.path.join(work_dir, "PSF")
    os.makedirs(psf_dir, exist_ok=True)
    np.save(os.path.join(psf_dir, "psf.npy"),
            gaussian_psf(wavel_axis, step_arcsec))

    # 5. fusion (the production entry, unmodified)
    t0 = _time.perf_counter()
    res, model = run_real_fusion(
        work_dir, [band], npix=npix, mu=mu, niter=niter, method=method,
        scale_data=True,  # Jy/sr → Jy: slit β-weight sum × SRF (ref :225-239)
        output_dir=os.path.join(work_dir, "out"),
        step_arcsec=step_arcsec,
    )
    report["t_fusion_s"] = round(_time.perf_counter() - t0, 2)

    data_dict = load_corrected_data(filt_dir, [band])
    y = model.real_data_janskySR_to_jansky(
        assemble_data_vector(model, data_dict, [band])
    )
    yhat = np.asarray(model.forward(res.x))
    mask = np.abs(y) > 0  # Shepard leaves zeros where no sample is in range
    report["residual_rel"] = float(
        np.linalg.norm((yhat - y)[mask]) / np.linalg.norm(y[mask])
    )
    report["n_iterations"] = int(len(res.grad_norm))

    # 6. flux comparison: fused model cube vs the data re-projected to cube
    # space (the reference's fused-vs-real mean-flux check)
    chan = model.channels[0]
    data_cube = np.asarray(chan.sliceToCube(model.split(y)[0]))  # full axis
    fused_cube = np.asarray(model.mapsToCube(res.x))
    flux_fused = metrics.nonzero_mean_per_slice(fused_cube)
    flux_data = metrics.nonzero_mean_per_slice(data_cube)
    ok = (flux_data > 0) & (flux_fused > 0)
    # the dirac re-projection carries different units than the model cube
    # (no Jy/sr scaling), so compare the CURVE SHAPES: unit-mean normalize,
    # then the per-λ ratio and the correlation pin the spectral agreement
    ff = flux_fused[ok] / flux_fused[ok].mean()
    fd = flux_data[ok] / flux_data[ok].mean()
    report["flux_ratio_median"] = float(np.median(ff / fd))
    report["flux_shape_corr"] = float(np.corrcoef(ff, fd)[0, 1])
    report["flux_points"] = int(ok.sum())
    out_dir = os.path.join(work_dir, "out")
    np.savez(os.path.join(out_dir, "flux_compare.npz"),
             mean_flux_fusion=flux_fused, mean_flux_real=flux_data)
    report["output_dir"] = out_dir
    return report


def run_allband_simulated(
    npix: int = 61,
    bands: Optional[Sequence[str]] = None,
    n_pointings: int = 4,
    n_templates: int = 4,
    mu: float = 5e3,
    niter: int = 50,
    method: str = "lcg",
    nmf_iter: int = 300,
    mask_threshold_q: float = 0.25,
    output_dir: Optional[str] = None,
    window_local: bool = False,
    lambda_subsample: int = 1,
    seed: int = 19940407,
) -> Dict:
    """BASELINE config 5 as one pipeline: all-band data → on-device NMF
    templates → 12-band LMM fusion → metrics.

    The reference runs this as a notebook + script chain
    (notebooks/nmf_orion_allband.ipynb learns templates from a co-added real
    hypercube, scripts/main_fusion.py:215-273 then fuses with them); here the
    chain is one call on simulated all-band data:

      1. simulate detector data through the all-band operator;
      2. co-add the data back to a dirty hypercube (per-channel
         `sliceToCube`, coverage-normalized) — the analog of the notebook's
         data cube;
      3. learn `n_templates` NMF templates on device from the masked cube
         (`learning.decomposition.learn_templates_nmf`);
      4. rebuild the operator with the LEARNED templates and solve;
      5. report per-stage timings and reconstruction metrics in cube space
         (template spaces differ, so maps are not comparable directly).
    """
    import time as _time

    import jax.numpy as jnp

    from .learning.decomposition import learn_templates_nmf
    from .models.spectro import SpectroSigRLSCT
    from .simulation.flagship import make_allband_setup
    from .solvers.criterion import QuadCriterion_MRS
    from .utils import metrics

    timings = {}
    t0 = _time.perf_counter()
    setup = make_allband_setup(
        npix=npix, bands=list(bands) if bands else None,
        n_pointings=n_pointings, n_tpl=n_templates,
        lambda_subsample=lambda_subsample, seed=seed,
    )

    def _build(templates):
        return SpectroSigRLSCT(
            setup["sotf"], templates, setup["alpha_axis"], setup["beta_axis"],
            setup["wavelength_axis"], setup["instrs"], setup["step_degree"],
            setup["pointings"], dtype=jnp.float32, window_local=window_local,
        )

    model = _build(setup["templates"])
    timings["build_s"] = _time.perf_counter() - t0

    truth_maps = np.asarray(setup["maps"], np.float32)
    truth_cube = np.asarray(model.mapsToCube(truth_maps))
    t0 = _time.perf_counter()
    y = np.asarray(model.forward(truth_maps))
    timings["simulate_s"] = _time.perf_counter() - t0

    # 2. dirty hypercube: coverage-normalized co-add of the detector data
    t0 = _time.perf_counter()
    blocks = model.split(y)
    cube0 = np.zeros(model.cube_shape)
    cover = np.zeros(model.cube_shape[0])
    for c, chan in enumerate(model.channels):
        cube0 += chan.sliceToCube(blocks[c])
        cover[chan.wslice] += 1.0
    cube0 /= np.maximum(cover, 1.0)[:, None, None]
    timings["coadd_s"] = _time.perf_counter() - t0

    # 3. NMF templates from the bright region of the dirty cube
    t0 = _time.perf_counter()
    bright = cube0.sum(axis=0)
    mask = bright > np.quantile(bright, mask_threshold_q)
    templates, _maps0, nmf_err = learn_templates_nmf(
        np.maximum(cube0, 0.0), n_templates, mask=mask, n_iter=nmf_iter,
        seed=seed,
    )
    timings["nmf_s"] = _time.perf_counter() - t0

    # 4. fuse with the learned templates.  Rows are normalized to unit L2
    # first: the LMM is scale-invariant between templates and maps, but
    # unnormalized NMF rows (O(10-100) on bright cubes) square into HᵗH and
    # push float32 CG quantities past overflow at production scale
    # (observed: all-NaN solve at 201²/12-band with rows ~80).
    tnorm = np.linalg.norm(templates, axis=1, keepdims=True)
    templates = templates / np.maximum(tnorm, 1e-30)
    model2 = _build(np.ascontiguousarray(templates))
    t0 = _time.perf_counter()
    crit = QuadCriterion_MRS(1.0, y, model2, mu)
    res = crit.run_method(method, maximum_iterations=niter)
    timings["solve_s"] = _time.perf_counter() - t0

    res_cube = np.asarray(model2.mapsToCube(res.x))
    report = {
        "bands": list(setup["bands"]),
        "n_lambda": int(model.cube_shape[0]),
        "npix": npix,
        "niter": int(res.n_iter),
        "iters_per_s": res.n_iter / max(timings["solve_s"], 1e-9),
        "nmf_recon_err": float(nmf_err),
        "psnr_cube": metrics.psnr(truth_cube, res_cube),
        "relative_cube_error_pct": metrics.relative_error(truth_cube, res_cube),
        "timings_s": {k: round(v, 3) for k, v in timings.items()},
    }
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        np.save(os.path.join(output_dir, "allband_templates.npy"), templates)
        np.save(os.path.join(output_dir, "allband_x.npy"), res.x)
        np.save(os.path.join(output_dir, "allband_cube.npy"), res_cube)
    return report
