"""Native JWST diffraction PSF generation (webbpsf replacement).

The reference generates monochromatic MIRI PSF stacks with the `webbpsf`
package (/root/reference/scripts/webbpsf_generation.py:10-50: one
`miri.calc_psf(monochromatic=λ, fov_arcsec, pixelscale)` call per λ, stacked
to a ``[Nλ, npix, npix]`` ``.npy``).  webbpsf is not installable here, so
this module computes the same physical-optics quantity natively:

1. ``jwst_pupil`` builds the segmented JWST aperture transmission mask on the
   host — 18 hexagonal segments (flat-to-flat 1.32 m, 7 mm gaps, missing
   central segment) plus the three secondary-support struts.
2. ``monochromatic_psf`` propagates it with a **matrix Fourier transform**
   (Soummer et al. 2007, Opt. Express 15, 15935): the Fraunhofer integral
   evaluated directly on the requested detector grid as two dense matmuls
   per axis.  On the accelerator the whole λ-stack is a batch of real
   matmuls (complex arithmetic expanded to planar real/imag), jitted and
   scanned.

Differences vs webbpsf, by design: no OPD/wavefront-error maps (webbpsf
loads measured OPDs; we are diffraction-limited), no instrument internal
optics, fixed pupil orientation.  The envelope (λ/D core, hex diffraction
spikes, energy normalization) matches the physical optics; tests pin the
core FWHM against the λ/D law and the Parseval energy budget.

Normalization follows webbpsf's ``normalize='last'`` convention as used by
the reference: the PSF integrated over the *infinite* focal plane is 1, so
a finite fov stack sums to slightly less (the scattered tail).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# JWST aperture geometry (public values, metres)
# ---------------------------------------------------------------------------

SEGMENT_FLAT_TO_FLAT = 1.32  # per-segment flat-to-flat
SEGMENT_GAP = 0.007  # edge-to-edge gap between segments
STRUT_WIDTH = 0.1  # secondary-support vane width
PUPIL_DIAMETER = 6.603464  # circumscribing diameter used by webbpsf


def _hex_mask(x: np.ndarray, y: np.ndarray, cx: float, cy: float, f2f: float) -> np.ndarray:
    """Boolean inside-test for a vertex-up hexagon of flat-to-flat `f2f`.

    Flats face the 0/60/120-degree axes, so neighbouring segments abut
    across flats along those directions (the JWST packing).
    """
    dx = x - cx
    dy = y - cy
    r = f2f / 2.0
    inside = np.abs(dx) <= r
    for ang in (np.pi / 3.0, 2.0 * np.pi / 3.0):
        u = dx * math.cos(ang) + dy * math.sin(ang)
        inside &= np.abs(u) <= r
    return inside


def segment_centers() -> list:
    """(cx, cy) of the 18 JWST primary segments in metres (ring 1 = A1-A6,
    then alternating B/C segments of ring 2 — the order `jwst_pupil` draws
    them and the order per-segment terms in a recorded OPD fixture use)."""
    pitch = SEGMENT_FLAT_TO_FLAT + SEGMENT_GAP
    centers = []
    for k in range(6):
        ang = k * np.pi / 3.0
        centers.append((pitch * math.cos(ang), pitch * math.sin(ang)))
    for k in range(6):
        ang = k * np.pi / 3.0
        centers.append((2.0 * pitch * math.cos(ang), 2.0 * pitch * math.sin(ang)))
        ang2 = ang + np.pi / 6.0
        d2 = math.sqrt(3.0) * pitch
        centers.append((d2 * math.cos(ang2), d2 * math.sin(ang2)))
    return centers


def jwst_pupil(n: int = 512, diameter: float = PUPIL_DIAMETER) -> np.ndarray:
    """The JWST aperture transmission mask on an n x n grid of width `diameter`.

    18 hexagonal segments in two rings around a missing centre segment,
    minus three 0.1 m secondary-support struts (one along +y, two at
    +/-120 degrees).  Returns float32 in [0, 1] (binary here; kept float so an
    apodization or per-segment piston could be folded in later).
    """
    ax = (np.arange(n) - (n - 1) / 2.0) * (diameter / n)
    x, y = np.meshgrid(ax, ax, indexing="xy")

    centers = segment_centers()
    mask = np.zeros((n, n), dtype=bool)
    for cx, cy in centers:
        mask |= _hex_mask(x, y, cx, cy, SEGMENT_FLAT_TO_FLAT)

    # secondary-support struts: one vane along +y, two at ±120° from it
    for ang in (np.pi / 2.0, np.pi / 2.0 + 2.0 * np.pi / 3.0, np.pi / 2.0 - 2.0 * np.pi / 3.0):
        ux, uy = math.cos(ang), math.sin(ang)
        along = x * ux + y * uy
        across = -x * uy + y * ux
        strut = (np.abs(across) <= STRUT_WIDTH / 2.0) & (along >= 0.0)
        mask &= ~strut

    return mask.astype(np.float32)


# ---------------------------------------------------------------------------
# Matrix Fourier transform propagation (jittable; planar complex)
# ---------------------------------------------------------------------------

ARCSEC_TO_RAD = np.pi / (180.0 * 3600.0)


def _mft_kernels(n_pup: int, diameter: float, npix: int, pixelscale_arcsec: float, wavelength_m: float):
    """Host-NumPy MFT kernel factors cos/sin[npix, n_pup] for one λ.

    K[k, j] = exp(-2πi θ_k x_j / λ) with x the pupil sample coordinates and
    θ the detector pixel angles; returned as separate cos/sin planes.
    """
    x = (np.arange(n_pup) - (n_pup - 1) / 2.0) * (diameter / n_pup)
    theta = (np.arange(npix) - (npix - 1) / 2.0) * (pixelscale_arcsec * ARCSEC_TO_RAD)
    phase = -2.0 * np.pi * np.outer(theta, x) / wavelength_m
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


def _psf_from_kernels(pupil, kc, ks, norm: float, pupil_im=None):
    """|K (P) Kᵀ|² with planar complex matmuls (jax or numpy arrays).

    `pupil` is the real part of the (possibly complex) pupil function;
    `pupil_im` the imaginary part when a wavefront error is folded in
    (P = mask·e^{2πi·OPD/λ}).  All complex arithmetic stays planar (real
    re/im arrays)."""
    if isinstance(pupil, np.ndarray):
        mm = np.matmul
    else:
        import jax.numpy as jnp

        # f32 PSF fidelity: the default matmul precision may round the
        # operands (TF32 on the GPU; see core/precision.py) — pin full f32
        def mm(a, b):
            return jnp.matmul(a, b, precision="highest")

    # A = K @ P  ->  A_re = kc@Pr − ks@Pi, A_im = ks@Pr + kc@Pi
    if pupil_im is None:
        a_re = mm(kc, pupil)
        a_im = mm(ks, pupil)
    else:
        a_re = mm(kc, pupil) - mm(ks, pupil_im)
        a_im = mm(ks, pupil) + mm(kc, pupil_im)
    # E = A @ K^T  -> E_re = A_re@kc^T - A_im@ks^T ; E_im = A_re@ks^T + A_im@kc^T
    e_re = mm(a_re, kc.T) - mm(a_im, ks.T)
    e_im = mm(a_re, ks.T) + mm(a_im, kc.T)
    return (e_re * e_re + e_im * e_im) * norm


# ---------------------------------------------------------------------------
# Wavefront error (OPD) support — the capability of webbpsf's measured-OPD
# files (/root/reference/notebooks/webbpsf_generation.ipynb loads them into
# the pupil plane); here the map is injected as a pupil phase screen.
# ---------------------------------------------------------------------------

# (n, m) for Noll indices 1..15 (piston, tilts, defocus, astig, coma,
# trefoil, spherical, secondary astig, quadrafoil)
_NOLL_NM = {
    1: (0, 0), 2: (1, 1), 3: (1, -1), 4: (2, 0), 5: (2, -2), 6: (2, 2),
    7: (3, -1), 8: (3, 1), 9: (3, -3), 10: (3, 3), 11: (4, 0),
    12: (4, 2), 13: (4, -2), 14: (4, 4), 15: (4, -4),
}


def _zernike_nm(n: int, m: int, rho: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Zernike polynomial Z_n^m on the unit disk (unnormalized, Z ∈ [−1, 1])."""
    am = abs(m)
    r = np.zeros_like(rho)
    for k in range((n - am) // 2 + 1):
        c = ((-1.0) ** k * math.factorial(n - k)
             / (math.factorial(k) * math.factorial((n + am) // 2 - k)
                * math.factorial((n - am) // 2 - k)))
        r = r + c * rho ** (n - 2 * k)
    if m > 0:
        return r * np.cos(am * theta)
    if m < 0:
        return r * np.sin(am * theta)
    return r


def zernike_opd(
    n_pupil: int,
    coeffs: dict,
    diameter: float = PUPIL_DIAMETER,
) -> np.ndarray:
    """Synthetic OPD map [n_pupil, n_pupil] in METERS from Zernike terms.

    `coeffs` maps Noll index (1..15) → coefficient in meters (the peak
    amplitude of the unnormalized polynomial over the circumscribed disk).
    Zero outside the unit disk.  Used to exercise the OPD hook without
    webbpsf's measured wavefront files (absent from this image)."""
    ax = (np.arange(n_pupil) - (n_pupil - 1) / 2.0) * (diameter / n_pupil)
    x, y = np.meshgrid(ax, ax, indexing="xy")
    rho = np.hypot(x, y) / (diameter / 2.0)
    theta = np.arctan2(y, x)
    opd = np.zeros((n_pupil, n_pupil), np.float64)
    for noll, c in coeffs.items():
        n, m = _NOLL_NM[int(noll)]
        opd += float(c) * _zernike_nm(n, m, np.clip(rho, 0.0, 1.0), theta)
    opd[rho > 1.0] = 0.0
    return opd


def load_opd(path: str, n_pupil: int, unit: str = "m") -> np.ndarray:
    """Load a wavefront/OPD map (.fits or .npy) and resample it to the
    pupil grid by bilinear interpolation.  Returns meters.

    The map is assumed to span the full pupil diameter (webbpsf OPD-file
    convention).  `unit`: m | um | nm."""
    if path.endswith(".npy"):
        opd = np.load(path)
    else:
        from ..preprocessing.fits_io import fits_open

        hdus = fits_open(path)
        opd = next(
            h.data for h in hdus
            if h.data is not None and np.ndim(h.data) == 2
        )
    opd = np.asarray(opd, np.float64)
    scale = {"m": 1.0, "um": 1e-6, "nm": 1e-9}[unit]
    opd = opd * scale
    n_in = opd.shape[0]
    if opd.shape != (n_pupil, n_pupil):
        # bilinear resample onto the pupil grid
        t = np.linspace(0.0, n_in - 1.0, n_pupil)
        i0 = np.clip(np.floor(t).astype(int), 0, n_in - 2)
        f = t - i0
        rows = opd[i0] * (1 - f)[:, None] + opd[i0 + 1] * f[:, None]
        cols = rows[:, i0] * (1 - f)[None, :] + rows[:, i0 + 1] * f[None, :]
        opd = cols
    return opd


def recorded_opd(
    path_or_dict,
    n_pupil: int,
    diameter: float = PUPIL_DIAMETER,
) -> np.ndarray:
    """OPD map [n_pupil, n_pupil] in METERS from a recorded decomposition.

    The fixture (JSON file or dict) holds a Zernike + per-segment
    decomposition of a JWST wavefront:

    * ``zernike_noll_nm``: {Noll index: coefficient in nm} — global
      low-order terms over the full pupil;
    * ``segment_piston_nm``: 18 per-segment pistons (nm), ordered as
      :func:`segment_centers`;
    * ``segment_tilt_nm``: optional 18 [tx, ty] pairs — peak-to-edge
      amplitude (nm) of a linear ramp across each segment.

    The bundled ``surfh_tpu/data/jwst_opd_commissioning.json`` reproduces
    the published in-flight wavefront-error level (see its ``provenance``
    field); any webbpsf-style OPD FITS/npy can be used instead via
    :func:`load_opd`."""
    import json as _json

    if isinstance(path_or_dict, dict):
        rec = path_or_dict
    else:
        with open(path_or_dict) as fh:
            rec = _json.load(fh)
    zern = {int(k): float(v) * 1e-9
            for k, v in rec.get("zernike_noll_nm", {}).items()}
    opd = zernike_opd(n_pupil, zern, diameter)

    pistons = rec.get("segment_piston_nm")
    tilts = rec.get("segment_tilt_nm")
    if pistons is not None or tilts is not None:
        ax = (np.arange(n_pupil) - (n_pupil - 1) / 2.0) * (diameter / n_pupil)
        x, y = np.meshgrid(ax, ax, indexing="xy")
        half_f2f = SEGMENT_FLAT_TO_FLAT / 2.0
        for i, (cx, cy) in enumerate(segment_centers()):
            seg = _hex_mask(x, y, cx, cy, SEGMENT_FLAT_TO_FLAT)
            term = np.zeros_like(opd)
            if pistons is not None:
                term += float(pistons[i]) * 1e-9
            if tilts is not None:
                tx, ty = tilts[i]
                term += (float(tx) * 1e-9 * (x - cx)
                         + float(ty) * 1e-9 * (y - cy)) / half_f2f
            opd[seg] += term[seg]
    return opd


def _pupil_planes(pupil: np.ndarray, opd_m, lam_m: float):
    """(Re, Im) of mask·e^{2πi·OPD/λ}; Im is None without an OPD."""
    if opd_m is None:
        return pupil, None
    ph = (2.0 * np.pi / lam_m) * np.asarray(opd_m, np.float64)
    return (
        (pupil * np.cos(ph)).astype(np.float32),
        (pupil * np.sin(ph)).astype(np.float32),
    )


def monochromatic_psf(
    pupil: np.ndarray,
    wavelength_um: float,
    pixelscale_arcsec: float,
    npix: int,
    diameter: float = PUPIL_DIAMETER,
    opd: Optional[np.ndarray] = None,
) -> np.ndarray:
    """One diffraction PSF [npix, npix], unit total energy over the full plane.

    Normalization: E(θ) = (dx²/λ)·Σ P e^{-2πi x·θ/λ}, psf_pixel = |E|²·dθ²/A
    with A the pupil area — Parseval then gives Σ_infinite psf = 1 (webbpsf
    'last' convention; a finite fov sums to slightly less).  A pure-phase
    OPD screen (`opd`, meters, pupil-grid shape) leaves |P| and hence the
    total energy unchanged.
    """
    n_pup = pupil.shape[0]
    lam_m = wavelength_um * 1e-6
    kc, ks = _mft_kernels(n_pup, diameter, npix, pixelscale_arcsec, lam_m)
    dx = diameter / n_pup
    dtheta = pixelscale_arcsec * ARCSEC_TO_RAD
    area = float(pupil.sum()) * dx * dx
    norm = (dx * dx / lam_m) ** 2 * dtheta * dtheta / area
    pr, pi = _pupil_planes(np.asarray(pupil, np.float32), opd, lam_m)
    return np.asarray(_psf_from_kernels(pr, kc, ks, norm, pupil_im=pi))


def psf_stack_device(
    wavel_axis,
    pixelscale_arcsec: float = 0.025,
    npix: int = 501,
    oversample: int = 1,
    n_pupil: int = 256,
    diameter: float = PUPIL_DIAMETER,
    chunk: int = 64,
    opd: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Whole-stack PSF generation on the accelerator, kernels built in-graph.

    The host→device traffic is just the pupil mask (once) and the λ values:
    the MFT cos/sin kernels are computed on device per λ (elementwise
    transcendentals feeding matmuls), and the stack is produced `chunk`
    λ-planes per dispatch with `jax.vmap` — the device-resident equivalent
    of webbpsf's per-λ `calc_psf` loop (hours of CPU for a 12-band stack).
    Output f32.
    """
    import jax
    import jax.numpy as jnp

    wavels = np.asarray(wavel_axis, dtype=np.float64)
    pupil = jwst_pupil(n_pupil, diameter)
    fine_n = npix * oversample
    fine_scale = pixelscale_arcsec / oversample
    dx = diameter / n_pupil
    dtheta = fine_scale * ARCSEC_TO_RAD
    area = float(pupil.sum()) * dx * dx

    x_host = ((np.arange(n_pupil) - (n_pupil - 1) / 2.0) * dx).astype(np.float32)
    th_host = ((np.arange(fine_n) - (fine_n - 1) / 2.0) * dtheta).astype(np.float32)

    has_opd = opd is not None
    opd_f32 = np.asarray(opd, np.float32) if has_opd else np.zeros((1, 1), np.float32)

    @jax.jit
    def _chunk(pup, opd_dev, x, theta, lams_m, norms):
        def one(lam_m, norm):
            phase = (-2.0 * jnp.pi / lam_m) * jnp.outer(theta, x)
            if has_opd:
                ph = (2.0 * jnp.pi / lam_m) * opd_dev
                pr, pi = pup * jnp.cos(ph), pup * jnp.sin(ph)
            else:
                pr, pi = pup, None
            psf = _psf_from_kernels(pr, jnp.cos(phase), jnp.sin(phase), norm,
                                    pupil_im=pi)
            if oversample > 1:
                psf = psf.reshape(npix, oversample, npix, oversample).sum(axis=(1, 3))
            return psf

        return jax.vmap(one)(lams_m, norms)

    pup_dev = jnp.asarray(pupil)
    opd_dev = jnp.asarray(opd_f32)
    x_dev = jnp.asarray(x_host)
    th_dev = jnp.asarray(th_host)

    out = np.empty((len(wavels), npix, npix), dtype=np.float32)
    for i in range(0, len(wavels), chunk):
        lam_m = wavels[i : i + chunk] * 1e-6
        norms = ((dx * dx / lam_m) ** 2 * dtheta * dtheta / area).astype(np.float32)
        # pad the tail chunk so one compiled program serves the whole axis
        pad = chunk - len(lam_m)
        if pad:
            lam_m = np.concatenate([lam_m, np.full(pad, lam_m[-1])])
            norms = np.concatenate([norms, norms[-1:].repeat(pad)])
        res = _chunk(pup_dev, opd_dev, x_dev, th_dev,
                     jnp.asarray(lam_m, jnp.float32), jnp.asarray(norms))
        out[i : i + chunk] = np.asarray(res)[: chunk - pad if pad else chunk]
    return out


def psf_stack(
    wavel_axis,
    pixelscale_arcsec: float = 0.025,
    npix: int = 501,
    oversample: int = 1,
    n_pupil: int = 256,
    diameter: float = PUPIL_DIAMETER,
    use_jax: Optional[bool] = None,
    opd: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Monochromatic PSF stack [Nλ, npix, npix] ≙ webbpsf_generation.py:10-50.

    `oversample` computes on a finer grid then box-bins to the detector
    sampling (webbpsf's detector-sampled output).  With `use_jax` (default:
    auto — on when jax is importable) each λ's six [npix·os, n_pupil]
    matmuls run jitted on the default backend; the kernels are rebuilt on the
    host per λ (they depend on λ), so device work streams while the host
    prepares the next plane.
    """
    wavel_axis = np.asarray(wavel_axis, dtype=np.float64)
    pupil = jwst_pupil(n_pupil, diameter)
    fine_n = npix * oversample
    fine_scale = pixelscale_arcsec / oversample

    if use_jax is None:
        try:
            import jax  # noqa: F401

            use_jax = True
        except Exception:  # pragma: no cover - jax is baked into this image
            use_jax = False

    if use_jax:
        import jax
        import jax.numpy as jnp

        @partial(jax.jit, static_argnames=("with_im",))
        def _one(pr, pi, kc, ks, norm, with_im=False):
            psf = _psf_from_kernels(pr, kc, ks, norm,
                                    pupil_im=pi if with_im else None)
            if oversample > 1:
                psf = psf.reshape(npix, oversample, npix, oversample).sum(axis=(1, 3))
            return psf

        pup_dev = jnp.asarray(pupil)
    dx = diameter / n_pupil
    dtheta = fine_scale * ARCSEC_TO_RAD
    area = float(pupil.sum()) * dx * dx

    out = np.empty((len(wavel_axis), npix, npix), dtype=np.float32)
    for i, lam_um in enumerate(wavel_axis):
        lam_m = float(lam_um) * 1e-6
        kc, ks = _mft_kernels(n_pupil, diameter, fine_n, fine_scale, lam_m)
        norm = (dx * dx / lam_m) ** 2 * dtheta * dtheta / area
        pr, pi = _pupil_planes(pupil, opd, lam_m)
        if use_jax:
            out[i] = np.asarray(_one(
                jnp.asarray(pr) if opd is not None else pup_dev,
                jnp.asarray(pi if pi is not None else pr),
                kc, ks, np.float32(norm), with_im=opd is not None,
            ))
        else:
            psf = _psf_from_kernels(pr, kc, ks, norm, pupil_im=pi)
            if oversample > 1:
                psf = psf.reshape(npix, oversample, npix, oversample).sum(axis=(1, 3))
            out[i] = psf
    return out
