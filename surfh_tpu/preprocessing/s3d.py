"""Real s3d data-cube ingestion: resample a JWST pipeline ChannelCube
(`*_s3d.fits`) onto the fusion model's regular (α, β) grid.

This is the data-converter step of the reference's
`scripts/fusion/generate_real_data_*.py` / `convert_fits_to_numpy_slices.py`
chain (generate_real_data_single_fits.py:119-233): read the s3d cube, NaN
the detector borders, build per-pixel world coordinates, optionally
block-oversample, then scattered-linear-interpolate each λ plane onto the
model grid.  The interpolated cube then feeds
`Channel.realData_cubeToSlice` to produce per-slit numpy data (":265-267").

Design deltas from the reference (host-side prep, NumPy/SciPy — none of
this runs on the accelerator):

- The Delaunay triangulation of the scattered (RA, DEC) point cloud is
  built ONCE and reused for every λ plane (the reference calls
  ``scipy.interpolate.griddata`` per plane, re-triangulating ~10³ times).
- Oversampling is a block replication (`np.repeat`) + bilinear coordinate
  ramp instead of the reference's stamp-plus-box-convolution and
  row/column ramp fills (generate_real_data_single_fits.py:144-201) —
  same intent (refine the point cloud so the target step ≪ source step
  case stays well-conditioned), expressed in vectorized form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .fits_io import fits_open

__all__ = [
    "read_s3d",
    "nan_border",
    "oversample_plane_cloud",
    "resample_cube_to_grid",
]


def read_s3d(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read a JWST s3d ChannelCube: (cube[λ, y, x], wavel_axis, ra_map, dec_map).

    Uses the linear core of the FITS WCS (CRVALi/CRPIXi/CDELTi, with the
    optional PC matrix for the celestial axes) — the s3d products written
    by the JWST pipeline are regular grids, so this matches
    ``astropy.wcs.WCS.wcs_pix2world`` on them
    (reference generate_real_data_single_fits.py:134-142).
    """
    hdus = fits_open(path)
    hdu = next(h for h in hdus if h.data is not None and np.ndim(h.data) == 3)
    hdr = hdu.header
    cube = np.asarray(hdu.data, np.float64)
    nlam, ny, nx = cube.shape

    def axis_world(n, i):
        crval = float(hdr.get(f"CRVAL{i}", 0.0))
        crpix = float(hdr.get(f"CRPIX{i}", 1.0))
        cdelt = float(hdr.get(f"CDELT{i}", 1.0))
        return crval + (np.arange(n) + 1 - crpix) * cdelt

    wavel = axis_world(nlam, 3)
    xpix, ypix = np.meshgrid(np.arange(nx, dtype=np.float64),
                             np.arange(ny, dtype=np.float64))
    # celestial axes: RA = axis 1, DEC = axis 2, with optional PC rotation
    crval1 = float(hdr.get("CRVAL1", 0.0))
    crval2 = float(hdr.get("CRVAL2", 0.0))
    crpix1 = float(hdr.get("CRPIX1", 1.0))
    crpix2 = float(hdr.get("CRPIX2", 1.0))
    cdelt1 = float(hdr.get("CDELT1", 1.0))
    cdelt2 = float(hdr.get("CDELT2", 1.0))
    pc11 = float(hdr.get("PC1_1", 1.0))
    pc12 = float(hdr.get("PC1_2", 0.0))
    pc21 = float(hdr.get("PC2_1", 0.0))
    pc22 = float(hdr.get("PC2_2", 1.0))
    dx = xpix + 1 - crpix1
    dy = ypix + 1 - crpix2
    ra_map = crval1 + cdelt1 * (pc11 * dx + pc12 * dy)
    dec_map = crval2 + cdelt2 * (pc21 * dx + pc22 * dy)
    return cube, wavel, ra_map, dec_map


def nan_border(cube: np.ndarray, width: int = 4) -> np.ndarray:
    """NaN the spatial borders of a (λ, y, x) cube — the s3d edge pixels
    are resampling artifacts (generate_real_data_single_fits.py:128-131)."""
    out = np.array(cube, np.float64, copy=True)
    if width > 0:
        out[:, :width, :] = np.nan
        out[:, -width:, :] = np.nan
        out[:, :, :width] = np.nan
        out[:, :, -width:] = np.nan
    return out


def oversample_plane_cloud(
    cube: np.ndarray, ra_map: np.ndarray, dec_map: np.ndarray, factor: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Refine the scattered point cloud ×factor per spatial axis: values are
    block-replicated, coordinates bilinearly ramped between native pixels
    (vectorized equivalent of generate_real_data_single_fits.py:144-201)."""
    if factor <= 1:
        return cube, ra_map, dec_map
    ny, nx = ra_map.shape
    vals = np.repeat(np.repeat(cube, factor, axis=1), factor, axis=2)

    def ramp(m):
        # per-pixel local steps (edge-extended), then bilinear sub-pixel fill
        iy = np.arange(ny * factor) / factor
        ix = np.arange(nx * factor) / factor
        i0 = np.clip(np.floor(iy).astype(int), 0, ny - 2)
        j0 = np.clip(np.floor(ix).astype(int), 0, nx - 2)
        fy = (iy - i0)[:, None]
        fx = (ix - j0)[None, :]
        m00 = m[np.ix_(i0, j0)]
        m10 = m[np.ix_(i0 + 1, j0)]
        m01 = m[np.ix_(i0, j0 + 1)]
        m11 = m[np.ix_(i0 + 1, j0 + 1)]
        return (m00 * (1 - fy) * (1 - fx) + m10 * fy * (1 - fx)
                + m01 * (1 - fy) * fx + m11 * fy * fx)

    return vals, ramp(ra_map), ramp(dec_map)


def resample_cube_to_grid(
    cube: np.ndarray,
    ra_map: np.ndarray,
    dec_map: np.ndarray,
    alpha_axis: np.ndarray,
    beta_axis: np.ndarray,
    oversample: int = 3,
    border: int = 4,
    fill_value: float = np.nan,
) -> np.ndarray:
    """Scattered-linear resampling of every λ plane onto the model's
    regular (α, β) grid → cube [λ, Nα, Nβ].

    The target layout matches the reference's xi construction
    (generate_real_data_single_fits.py:218-229): output pixel (a, b) sits
    at world (alpha_axis[b], beta_axis[a]) — α varies along the LAST axis.
    One Delaunay triangulation serves all λ planes.
    """
    from scipy.interpolate import LinearNDInterpolator
    from scipy.spatial import Delaunay

    cube = nan_border(np.asarray(cube, np.float64), border)
    vals, ra, dec = oversample_plane_cloud(cube, np.asarray(ra_map),
                                           np.asarray(dec_map), oversample)
    pts = np.stack([ra.ravel(), dec.ravel()], axis=-1)
    # Drop points with non-finite coordinates AND points that carry no data
    # in any plane (the NaN'd borders — a spatial pattern, identical across
    # λ, so one triangulation still serves every plane).  Zero-blending
    # those into edge triangles would bias border pixels toward 0.
    good = np.isfinite(pts).all(axis=1)
    good &= np.isfinite(vals).any(axis=0).ravel()
    tri = Delaunay(pts[good])

    aa = np.tile(np.asarray(alpha_axis)[None, :], (len(beta_axis), 1))
    bb = np.tile(np.asarray(beta_axis)[:, None], (1, len(alpha_axis)))
    xi = np.stack([aa.ravel(), bb.ravel()], axis=-1)

    out = np.empty((vals.shape[0], len(beta_axis), len(alpha_axis)), np.float64)
    for w in range(vals.shape[0]):
        v = vals[w].ravel()[good]
        # Residual per-plane NaNs (bad pixels inside the footprint) would
        # poison whole triangles; zero them like the reference does
        # post-hoc on the slices (":267").
        interp = LinearNDInterpolator(tri, np.nan_to_num(v), fill_value=fill_value)
        out[w] = interp(xi).reshape(len(beta_axis), len(alpha_axis))
    return out
