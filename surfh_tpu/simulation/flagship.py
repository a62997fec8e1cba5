"""The reference's real flagship fusion problem at full scale.

Mirrors the workload of `/root/reference/scripts/main_fusion.py:34-39` and
`fusion_real_data_multi_chan.py:443-461` (BASELINE.md): 12 MIRI MRS bands ×
4 dither pointings, 501² sky grid at the common super-resolution step, a
global cube λ axis built from the union of the 12 detector wavelength tables
subsampled ×3 (the reference's `wavel_axis.npy` is the instrument tables with
the same ×3 spectral smoothing, simulation_data.py:12-133 — ours lands at
~3879 samples vs the reference's 3182), λ-dependent PSF OTF, and LMM
templates.  Ground truth is synthetic (smooth positive spectra × random
abundance maps) — the benchmark measures operator/solver throughput, not
astrophysics.

Everything is sized so the model MUST run in `window_local` tables-as-args
mode: the full sotf alone is ~3.9 GB complex64.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np

import dataclasses

from ..core.fft import ir2fr
from ..instrument import miri, wavelength_mrs
from ..instrument.geometry import CoordList
from ..utils import cache as _cache
from ..utils.psf import gaussian_psf

# The reference's flagship runs at a fixed 0.025″ super-resolution step
# (main_fusion.py:74) with SRF = det_pix // step = [7, 7, 9, 10] per channel.
FLAGSHIP_STEP_ARCSEC = 0.025


def flagship_instruments(bands: Optional[List[str]] = None) -> list:
    """The 12 bands with their FULL detector wavelength tables.

    Matches `create_instruments` (main_fusion.py:103-134): FOV in degrees,
    centered origin, `wavelength_mrs` grids (1050/1213/… samples — the PCE
    calibration grids used by `miri.fusion_bands` are ~5× coarser), pce=None.
    """
    if bands is None:
        bands = list(miri.BANDS)
    return [
        dataclasses.replace(
            ifu, wavel_axis=wavelength_mrs.get_mrs_wavelength(b), pce=None
        )
        for b, ifu in zip(bands, miri.fusion_bands(bands))
    ]


def flagship_wavel_axis(bands: Optional[List[str]] = None, subsample: int = 3) -> np.ndarray:
    """Global cube λ axis: sorted union of the detector tables, ×`subsample`.

    The reference's `wavel_axis.npy` is the instrument tables with the same
    ×3 spectral smoothing (simulation_data.py:12-133), ≈3182 samples; the
    exact union lands at ~3879.
    """
    if bands is None:
        bands = miri.BANDS
    wavel = np.sort(
        np.concatenate([wavelength_mrs.get_mrs_wavelength(b) for b in bands])
    )
    return wavel[::subsample].copy()


def make_flagship_setup(
    npix: int = 501,
    bands: Optional[List[str]] = None,
    n_pointings: int = 4,
    n_tpl: int = 4,
    lambda_subsample: int = 3,
    seed: int = 19940407,
    build_sotf: bool = False,
):
    """Build the flagship-scale problem inputs (host arrays only).

    Returns the same dict keys as `synthetic.make_setup` so the model
    builders and bench are interchangeable.  By default the materialized
    OTF stack (`sotf`, ~3.9 GB complex64 + ~25 min of single-core FFTs at
    full scale) is NOT built — the model consumes the compact per-λ
    `psf_stack` and evaluates the OTF in-graph (fft.otf_from_stamps).
    Pass `build_sotf=True` for consumers that need the transfer function
    itself (FFT-mode conv, the numpy_ref CPU baseline).
    """
    if bands is None:
        bands = list(miri.BANDS)
    return _make_setup_from_instrs(
        flagship_instruments(bands), bands, npix, n_pointings, n_tpl,
        lambda_subsample, seed, build_sotf=build_sotf,
    )


def make_allband_setup(
    npix: int = 101,
    bands: Optional[List[str]] = None,
    n_pointings: int = 4,
    n_tpl: int = 4,
    lambda_subsample: int = 1,
    seed: int = 19940407,
    build_sotf: bool = True,
):
    """All-band problem on the PCE calibration λ grids (~201 samples/band —
    ~5× coarser than the detector tables): the BASELINE config-5 workload
    (all 12 bands + NMF templates) at a compile-light size.  Same dict keys
    as :func:`make_flagship_setup`."""
    if bands is None:
        bands = list(miri.BANDS)
    return _make_setup_from_instrs(
        miri.fusion_bands(bands), bands, npix, n_pointings, n_tpl,
        lambda_subsample, seed, build_sotf=build_sotf,
    )


def _make_setup_from_instrs(
    instrs, bands, npix, n_pointings, n_tpl, lambda_subsample, seed,
    build_sotf: bool = True,
):
    rng = np.random.default_rng(seed)

    step = FLAGSHIP_STEP_ARCSEC
    step_degree = step / 3600.0
    alpha_axis = (np.arange(npix) - npix / 2) * step_degree
    beta_axis = (np.arange(npix) - npix / 2) * step_degree

    wavelength_axis = np.sort(
        np.concatenate([np.asarray(ifu.wavel_axis) for ifu in instrs])
    )[::lambda_subsample].copy()
    n_lambda = len(wavelength_axis)

    # Smooth positive spectra: broad ramps + a few Gaussian emission bumps,
    # qualitatively like the Orion NMF templates the reference loads.
    lam01 = (wavelength_axis - wavelength_axis[0]) / (
        wavelength_axis[-1] - wavelength_axis[0]
    )
    templates = np.empty((n_tpl, n_lambda))
    for m in range(n_tpl):
        t = 0.5 + 0.5 * (m + 1) / n_tpl * lam01
        for _ in range(3):
            c, w, a = rng.uniform(0.05, 0.95), rng.uniform(0.01, 0.1), rng.uniform(0.5, 2.0)
            t = t + a * np.exp(-((lam01 - c) ** 2) / (2 * w**2))
        templates[m] = t
    maps = rng.random((n_tpl, npix, npix))

    # λ-dependent PSF stamp stack [Nλ, 40, 40] — compact and cheap; the
    # flagship model evaluates the OTF from it in-graph
    # (fft.otf_from_stamps), so the materialized sotf below is optional.
    # SURFH_SIM_PSF=diffraction swaps the gaussian approximation for the
    # native segmented-pupil physical-optics stack (utils/jwst_psf — the
    # webbpsf-equivalent the reference simulates with, simulation_data.py:96).
    if os.environ.get("SURFH_SIM_PSF", "gaussian") == "diffraction":
        from ..utils.jwst_psf import psf_stack as _diffraction_stack

        psf_stack = _diffraction_stack(wavelength_axis, step, npix=40)
        psf_stack = (psf_stack / psf_stack.sum(axis=(1, 2), keepdims=True)).astype(np.float32)
    else:
        psf_stack = gaussian_psf(wavelength_axis, step).astype(np.float32)
    if psf_stack.shape[1] > npix or psf_stack.shape[2] > npix:
        # center-crop kernels wider than the sky grid and renormalize
        # (same convention as synthetic.make_setup / the reference's
        # webbpsf crop, simulation_data.py:96-133)
        ca = max(0, (psf_stack.shape[1] - npix) // 2)
        cb = max(0, (psf_stack.shape[2] - npix) // 2)
        psf_stack = psf_stack[:, ca : ca + npix, cb : cb + npix]
        psf_stack = psf_stack / psf_stack.sum(axis=(1, 2), keepdims=True)

    # Materialized non-unitary OTF stack (~3.9 GB complex64 at full scale,
    # ~25 min of single-core FFTs — BASELINE.md), disk-cached/memmapped
    # under SURFH_CACHE_DIR.  Only for FFT-mode / numpy_ref consumers.
    sotf = None
    if build_sotf:
        cache_dir = os.environ.get("SURFH_CACHE_DIR") or _cache.cache_dir("arrays")
        # key on the λ-axis CONTENTS, not just its length: two band subsets
        # can have equal sample counts but different wavelengths (different
        # PSF widths per plane)
        lam_tag = hashlib.sha1(
            np.ascontiguousarray(wavelength_axis, np.float64).tobytes()
        ).hexdigest()[:12]
        # also key on the PSF stack CONTENTS: the same (npix, λ-axis) setup
        # can carry different PSF families (SURFH_SIM_PSF=gaussian vs
        # diffraction), and a stale sotf from the other family would silently
        # disagree with psf_stack for FFT-mode/numpy_ref consumers
        psf_tag = hashlib.sha1(
            np.ascontiguousarray(psf_stack, np.float32).tobytes()
        ).hexdigest()[:12]
        cache_key = f"sotf_n{npix}_l{n_lambda}_s{step}_{lam_tag}_{psf_tag}.npy"
        cache_path = os.path.join(cache_dir, cache_key)
        if os.path.exists(cache_path):
            sotf = np.load(cache_path, mmap_mode="r")
        else:
            sotf = np.empty((n_lambda, npix, npix // 2 + 1), np.complex64)
            chunk = 256
            for i in range(0, n_lambda, chunk):
                sotf[i : i + chunk] = ir2fr(
                    psf_stack[i : i + chunk], (npix, npix)
                ).astype(np.complex64)
            try:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = cache_path + ".tmp.npy"
                np.save(tmp, sotf)
                os.replace(tmp, cache_path)
            except OSError:
                pass  # cache is best-effort (read-only or full filesystem)

    dith = np.asarray(miri.dithering)[:n_pointings] / 3600.0
    pts = CoordList.from_array(dith)
    pointings = [pts for _ in instrs]

    return dict(
        maps=maps,
        templates=templates,
        wavelength_axis=wavelength_axis,
        alpha_axis=alpha_axis,
        beta_axis=beta_axis,
        sotf=sotf,
        psf_stack=psf_stack,
        instrs=instrs,
        pointings=pointings,
        step_degree=step_degree,
        im_shape=(npix, npix),
        bands=bands,
    )


def make_flagship_model(
    setup: Optional[dict] = None,
    dtype=None,
    wblur_impl: str = "dense",
    window_local: bool = True,
    conv_impl: str = "auto",
    conv_freq_rtol: Optional[float] = None,
    conv_precision: Optional[str] = None,
    conv_rank_rtol: Optional[float] = None,
    **kwargs,
):
    """Build the flagship `SpectroSigRLSCT` in window-local tabled mode.

    `conv_freq_rtol` defaults to 1e-6 (`SURFH_CONV_FREQ_RTOL` overrides):
    the flagship PSFs are band-limited Gaussians, so dropping DFT bins where
    the OTF is < 1e-6 of peak leaves a float32-class deviation while cutting
    the conv matmul FLOPs (PERF.md "frequency-truncated conv").

    `conv_precision` defaults to "highest" (`SURFH_CONV_PRECISION`
    overrides): the input precision of the conv matmuls
    (core/precision.py).  `conv_impl="auto"` follows
    `config.platform_policy`.
    """
    import jax.numpy as jnp

    from ..config import platform_policy

    from ..models.spectro import SpectroSigRLSCT

    resolved = conv_impl
    if resolved == "auto":
        resolved = platform_policy().conv_impl
    if setup is None:
        setup = make_flagship_setup(build_sotf=resolved == "fft", **kwargs)
    if dtype is None:
        dtype = jnp.float32
    if conv_freq_rtol is None:
        conv_freq_rtol = float(os.environ.get("SURFH_CONV_FREQ_RTOL", "1e-6"))
    if conv_precision is None:
        conv_precision = os.environ.get("SURFH_CONV_PRECISION", "highest")
    if conv_rank_rtol is None:
        # λ-rank factorized conv (fft.lmm_conv_rank): the gaussian stamps'
        # singular spectrum drops below 1e-7 at R ≈ 16 over the FULL λ axis
        # (lower per channel window), so the default keeps a float32-class
        # deviation while the post-conv pipeline runs on M·R instead of W
        # planes.  SURFH_CONV_RANK_RTOL=0 disables.
        conv_rank_rtol = float(os.environ.get("SURFH_CONV_RANK_RTOL", "1e-7"))
    # PSF-stamp mode (OTF evaluated in-graph from the compact stamps) is the
    # default whenever the matmul conv path will run; a materialized sotf is
    # only required for the FFT conv.  SURFH_PSF_STAMPS=0 forces the
    # OTF-window tables (needs setup built with build_sotf=True).
    use_stamps = (
        resolved == "matmul"
        and window_local
        and os.environ.get("SURFH_PSF_STAMPS", "1") != "0"
        and setup.get("psf_stack") is not None
    )
    if not use_stamps and setup.get("sotf") is None:
        raise ValueError(
            "this conv configuration needs the materialized sotf — rebuild "
            "the setup with make_flagship_setup(build_sotf=True)"
        )
    model = SpectroSigRLSCT(
        None if use_stamps else setup["sotf"],
        setup["templates"],
        setup["alpha_axis"],
        setup["beta_axis"],
        setup["wavelength_axis"],
        setup["instrs"],
        setup["step_degree"],
        setup["pointings"],
        dtype=dtype,
        wblur_impl=wblur_impl,
        window_local=window_local,
        conv_impl=conv_impl,
        conv_freq_rtol=conv_freq_rtol,
        psf_stack=setup["psf_stack"] if use_stamps else None,
        conv_precision=conv_precision,
        conv_rank_rtol=conv_rank_rtol,
    )
    return model, setup
