"""The single-stage operator ladder (the reference's `surfh.DottestModels`).

The reference pins this family's public interfaces through its dottest suite
(/root/reference/test/test_fw_ad.py:17-1026) — the modules themselves are
absent from the snapshot (imported from `surfh.DottestModels`; see SURVEY.md).
Semantics are reconstructed from the in-tree prototypes
(test/sandbox_dottest_wblur.py:85-177, test/sandbox_dottest_slicer.py:29-90)
and the in-tree flagship twins (surfh/Models/spectroModel.py,
spectroModelChannel.py).

Operator letters (spectroModel.py:25-38): T = LMM template mixing,
C = spatial convolution (λ-dependent PSF via FFT), S = cube→local-FOV
gridding, L = slit extraction with edge weights, R = spectral blur,
Sig = β-integration + α-subsampling onto detector pixels, MO = multi-pointing,
MC = multi-channel.

Design: every forward is one pure jittable function over static
precomputed tables; every adjoint is its exact `jax.linear_transpose` (the
LinOp base), so each model passes the dot test to float precision by
construction.
"""

from __future__ import annotations

from math import ceil
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bilinear, fft, lmm, wblur
from ..core.linop import LinOp
from ..core.nearest import nearest_plan
from ..instrument.geometry import Coord, CoordList, get_srf
from ..instrument.ifu import IFU
from .channel import Channel
from .slicer import Slicer
from .spectro import SpectroSigRLSCT as MCMO_SigRLSCT


def _npdtypes(dtype):
    if dtype == jnp.float32:
        return np.float32, np.complex64
    return np.float64, np.complex128


class SpectroT(LinOp):
    """y = T a — LMM template mixing (reference T_Model.spectroT)."""

    def __init__(self, maps, templates, wavelength_axis, dtype=jnp.float32):
        maps = np.asarray(maps)
        self.templates = np.asarray(templates)
        self.wavelength_axis = np.asarray(wavelength_axis)
        ishape = maps.shape
        oshape = (len(wavelength_axis), maps.shape[1], maps.shape[2])
        super().__init__(ishape, oshape, dtype)
        npdt, _ = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        self._fwd = jax.jit(lambda x: lmm.lmm_maps2cube(x, self._tpl))

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroC(LinOp):
    """y = C x — spatial convolution of a cube (reference C_Model.spectroC)."""

    def __init__(self, sotf, maps, templates, wavelength_axis, dtype=jnp.float32):
        maps = np.asarray(maps)
        self.sotf = np.asarray(sotf)
        shape = (len(wavelength_axis), maps.shape[1], maps.shape[2])
        super().__init__(shape, shape, dtype)
        _, npct = _npdtypes(dtype)
        self._sotf = np.asarray(sotf, npct)
        self._imshape = shape[1:]
        self._fwd = jax.jit(
            lambda x: fft.idft(fft.dft(x) * self._sotf, self._imshape)
        )

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroCT(LinOp):
    """y = C T a (reference CT_Model.spectroCT)."""

    def __init__(
        self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, dtype=jnp.float32
    ):
        templates = np.asarray(templates)
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(wavelength_axis), len(alpha_axis), len(beta_axis))
        super().__init__(ishape, oshape, dtype)
        npdt, npct = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        self._sotf = np.asarray(sotf, npct)
        self._imshape = oshape[1:]
        self._fwd = jax.jit(
            lambda x: fft.idft(
                fft.dft(lmm.lmm_maps2cube(x, self._tpl)) * self._sotf, self._imshape
            )
        )

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


def _origin_plan(instr, alpha_axis, beta_axis, step_degree, mode="bilinear", margin=0.0):
    """Gather plan from the global grid onto the instrument's local grid
    (one pointing at the FOV origin), plus the local axes."""
    local_a, local_b = instr.fov.local_coords(step_degree, margin, margin)
    ga, gb = instr.fov.local2global(local_a, local_b)
    pts = bilinear.grid_points(ga, gb)
    if mode == "nn":
        plan = nearest_plan(alpha_axis, beta_axis, pts)
    else:
        plan = bilinear.bilinear_plan(alpha_axis, beta_axis, pts)
    return local_a, local_b, plan


class SpectroST(LinOp):
    """y = S T a — LMM then gridding onto the rotated local FOV grid
    (reference ST_Model.spectroST)."""

    _gridding = "bilinear"

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        local_a, local_b, plan = _origin_plan(
            self.instr, alpha_axis, beta_axis, step_degree, self._gridding
        )
        self.local_alpha_axis, self.local_beta_axis = local_a, local_b
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(wavelength_axis), len(local_a), len(local_b))
        super().__init__(ishape, oshape, dtype)
        npdt, _ = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        idxs, ws = np.asarray(plan.idx), np.asarray(plan.w, npdt)
        nla, nlb = len(local_a), len(local_b)

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl)
            return bilinear.apply_plan(idxs, ws, cube).reshape(
                cube.shape[0], nla, nlb
            )

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroSnearestT(SpectroST):
    """y = S_NN T a — nearest-neighbor gridding variant
    (reference ST_Model.spectroSnearestT)."""

    _gridding = "nn"


class _MapsCubeMixin:
    """mapsToCube/cubeTomaps — the reference's fusion demo scripts call these
    on every family model (e.g. fusion_SCT_simulated.py:47,67)."""

    def mapsToCube(self, maps):
        return lmm.lmm_maps2cube(
            jnp.asarray(maps, self.dtype), self.templates.astype(np.float64)
        )

    def cubeTomaps(self, cube):
        return lmm.lmm_cube2maps(
            jnp.asarray(cube, self.dtype), self.templates.astype(np.float64)
        )


class SpectroSCT(_MapsCubeMixin, LinOp):
    """y = S C T a — LMM, λ-dependent PSF convolution, then gridding onto
    the rotated local FOV grid (reference SCT_Model.SCT_spectro — module
    absent from the snapshot; interface pinned by its driver script
    /root/reference/scripts/fusion/fusion_SCT_simulated.py:11,37)."""

    _gridding = "bilinear"

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        self.templates = templates
        self.instr = instr.pix(step_degree)
        local_a, local_b, plan = _origin_plan(
            self.instr, alpha_axis, beta_axis, step_degree, self._gridding
        )
        self.local_alpha_axis, self.local_beta_axis = local_a, local_b
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(wavelength_axis), len(local_a), len(local_b))
        super().__init__(ishape, oshape, dtype)
        npdt, npct = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        self._sotf = np.asarray(sotf, npct)
        idxs, ws = np.asarray(plan.idx), np.asarray(plan.w, npdt)
        nla, nlb = len(local_a), len(local_b)
        imshape = (len(alpha_axis), len(beta_axis))

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl)
            blurred = fft.idft(fft.dft(cube) * self._sotf, imshape)
            return bilinear.apply_plan(idxs, ws, blurred).reshape(
                blurred.shape[0], nla, nlb
            )

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroLT(LinOp):
    """y = L T a — LMM, gridding, then slit extraction
    (reference LT_Model.spectroLT; prototype sandbox_dottest_slicer.py:29-90)."""

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        local_a, local_b, plan = _origin_plan(
            self.instr, alpha_axis, beta_axis, step_degree, margin=5 * step_degree
        )
        self.slicer = Slicer(
            self.instr,
            wavelength_axis=np.asarray(wavelength_axis),
            alpha_axis=np.asarray(alpha_axis),
            beta_axis=np.asarray(beta_axis),
            local_alpha_axis=local_a,
            local_beta_axis=local_b,
            srf=1,
        )
        a0s, b0s, weights = self.slicer.slit_tables()
        _, sa, sb = self.slicer.get_slit_shape()
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (self.instr.n_slit, len(wavelength_axis), sa, sb)
        super().__init__(ishape, oshape, dtype)
        npdt, _ = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        idxs, ws = np.asarray(plan.idx), np.asarray(plan.w, npdt)
        wts = np.asarray(weights, npdt)
        nla, nlb = len(local_a), len(local_b)

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl)
            local = bilinear.apply_plan(idxs, ws, cube).reshape(
                cube.shape[0], nla, nlb
            )
            return jnp.stack(
                [
                    local[:, a0 : a0 + sa, b0 : b0 + sb] * wts[s][jnp.newaxis]
                    for s, (a0, b0) in enumerate(zip(a0s, b0s))
                ]
            )

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroLST(_MapsCubeMixin, SpectroLT):
    """y = L S T a — LMM, explicit rotated-FOV gridding, then slit
    extraction (reference LST_Model.spectroLST — module absent from the
    snapshot; interface pinned by its driver script
    /root/reference/scripts/fusion/fusion_LST_simulated.py:11,37, which runs
    it on a 45°-rotated FOV).

    Compositionally this is the same pipeline as :class:`SpectroLT`; the
    reference keeps them distinct because its LT harness uses an unrotated
    full-cube FOV (test_fw_ad.py:226-232 — angle=0, S degenerates to the
    identity resampling) while LST exercises the rotated gridding."""

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        dtype=jnp.float32,
    ):
        super().__init__(
            sotf, templates, alpha_axis, beta_axis, wavelength_axis,
            instr, step_degree, dtype=dtype,
        )
        self.templates = np.asarray(templates)


class SpectroMO_ST(_MapsCubeMixin, LinOp):
    """y[p] = S_p T a — multi-pointing gridding of the mixed cube, one
    rotated-local-FOV resampling per dither pointing, no convolution or
    spectral stage (reference MO_ST_Model.spectroST — module absent from
    the snapshot; interface pinned by its driver script
    /root/reference/scripts/fusion/fusion_MO_ST_simulated.py:11,44).

    Per-pointing plans follow the Channel convention (channel.py:176-181):
    shared local axes from the unshifted FOV, gather points from
    `(fov + pointing).local2global`."""

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        pointings,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        self.templates = templates
        self.instr = instr.pix(step_degree)
        self.pointings = CoordList(pointings).pix(step_degree)
        local_a, local_b = self.instr.fov.local_coords(step_degree, 0.0, 0.0)
        self.local_alpha_axis, self.local_beta_axis = local_a, local_b
        npdt, _ = _npdtypes(dtype)
        plans = []
        for p in self.pointings:
            fov = self.instr.fov + p
            ga, gb = fov.local2global(local_a, local_b)
            plan = bilinear.bilinear_plan(
                np.asarray(alpha_axis), np.asarray(beta_axis),
                bilinear.grid_points(ga, gb),
            )
            plans.append((np.asarray(plan.idx), np.asarray(plan.w, npdt)))
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (
            len(self.pointings), len(wavelength_axis), len(local_a), len(local_b)
        )
        super().__init__(ishape, oshape, dtype)
        self._tpl = np.asarray(templates, npdt)
        nla, nlb = len(local_a), len(local_b)

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl)
            return jnp.stack(
                [
                    bilinear.apply_plan(idx, w, cube).reshape(
                        cube.shape[0], nla, nlb
                    )
                    for idx, w in plans
                ]
            )

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


def _full_image_wpsf(instr, wavelength_axis, beta_axis):
    """wpsf [λ_det, λ_cube, Nβ] over the full image β extent
    (prototype sandbox_dottest_wblur.py:137-147)."""
    beta_step = beta_axis[1] - beta_axis[0]
    beta = np.arange(len(beta_axis)) * beta_step
    return instr.spectral_psf(
        beta - np.mean(beta),
        np.asarray(wavelength_axis),
        arcsec2micron=instr.wavel_step / instr.det_pix_size,
        type="mrs",
    )


class SpectroR(LinOp):
    """y = R x — spectral blur of a cube (reference R_Model.spectroR)."""

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        dtype=jnp.float32,
    ):
        self.templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        self.wavelength_axis = np.asarray(wavelength_axis)
        wpsf = _full_image_wpsf(self.instr, wavelength_axis, beta_axis)
        ishape = (len(wavelength_axis), len(alpha_axis), len(beta_axis))
        oshape = (wpsf.shape[0], len(alpha_axis), len(beta_axis))
        super().__init__(ishape, oshape, dtype)
        npdt, _ = _npdtypes(dtype)
        self._wpsf = np.asarray(wpsf, npdt)
        self._fwd = jax.jit(lambda x: wblur.wblur(x, self._wpsf))

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))

    def mapsToCube(self, maps):
        return lmm.lmm_maps2cube(jnp.asarray(maps, self.dtype), self.templates.astype(np.float64))

    def cubeTomaps(self, cube):
        return lmm.lmm_cube2maps(jnp.asarray(cube, self.dtype), self.templates.astype(np.float64))


class _RLBase(LinOp):
    """Shared R∘L pipeline: gridding → slit windows → per-slit spectral blur."""

    _with_lmm = False

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        self.wavelength_axis = np.asarray(wavelength_axis)
        local_a, local_b, plan = _origin_plan(
            self.instr, alpha_axis, beta_axis, step_degree, margin=5 * step_degree
        )
        self.slicer = Slicer(
            self.instr,
            wavelength_axis=self.wavelength_axis,
            alpha_axis=np.asarray(alpha_axis),
            beta_axis=np.asarray(beta_axis),
            local_alpha_axis=local_a,
            local_beta_axis=local_b,
            srf=1,
        )
        a0s, b0s, weights = self.slicer.slit_tables()
        _, sa, sb = self.slicer.get_slit_shape()
        # slit-width spectral PSF (per-slit β extent, channel convention)
        beta_step = beta_axis[1] - beta_axis[0]
        beta_in_slit = np.arange(sb) * beta_step
        wpsf = self.instr.spectral_psf(
            beta_in_slit - np.mean(beta_in_slit),
            self.wavelength_axis,
            arcsec2micron=self.instr.wavel_step / self.instr.det_pix_size,
            type="mrs",
        )
        if self._with_lmm:
            ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        else:
            ishape = (len(wavelength_axis), len(alpha_axis), len(beta_axis))
        oshape = (self.instr.n_slit, wpsf.shape[0], sa, sb)
        super().__init__(ishape, oshape, dtype)
        npdt, _ = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        idxs, ws = np.asarray(plan.idx), np.asarray(plan.w, npdt)
        wts = np.asarray(weights, npdt)
        wpsf = np.asarray(wpsf, npdt)
        nla, nlb = len(local_a), len(local_b)
        with_lmm = self._with_lmm

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl) if with_lmm else x
            local = bilinear.apply_plan(idxs, ws, cube).reshape(
                cube.shape[0], nla, nlb
            )
            slits = jnp.stack(
                [
                    local[:, a0 : a0 + sa, b0 : b0 + sb] * wts[s][jnp.newaxis]
                    for s, (a0, b0) in enumerate(zip(a0s, b0s))
                ]
            )  # [S, λ, sa, sb]
            return jax.vmap(lambda sl: wblur.wblur(sl, wpsf))(slits)

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroRL(_RLBase):
    """y = R L x on a cube (reference RL_Model.spectroRL)."""

    _with_lmm = False


class SpectroRLT(_RLBase):
    """y = R L T a on abundance maps (reference RLT_Model.spectroRLT;
    prototype sandbox_dottest_wblur.py:85-177)."""

    _with_lmm = True


class _SigRLBase(LinOp):
    """Shared Sig∘R∘L(∘C)∘T pipeline: LMM (+conv), gridding, slits,
    β-integrating spectral blur, α subsampling."""

    _with_conv = False

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        self.wavelength_axis = np.asarray(wavelength_axis)
        self.srf = get_srf([instr.det_pix_size], step_degree * 3600)[0]
        local_a, local_b, plan = _origin_plan(
            self.instr, alpha_axis, beta_axis, step_degree, margin=5 * step_degree
        )
        self.slicer = Slicer(
            self.instr,
            wavelength_axis=self.wavelength_axis,
            alpha_axis=np.asarray(alpha_axis),
            beta_axis=np.asarray(beta_axis),
            local_alpha_axis=local_a,
            local_beta_axis=local_b,
            srf=self.srf,
        )
        a0s, b0s, weights = self.slicer.slit_tables()
        _, sa, sb = self.slicer.get_slit_shape()
        n_aout = ceil(self.slicer.npix_slit_alpha_width / self.srf)
        beta_step = beta_axis[1] - beta_axis[0]
        beta_in_slit = np.arange(sb) * beta_step
        wpsf = self.instr.spectral_psf(
            beta_in_slit - np.mean(beta_in_slit),
            self.wavelength_axis,
            arcsec2micron=self.instr.wavel_step / self.instr.det_pix_size,
            type="mrs",
        )
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (self.instr.n_slit, wpsf.shape[0], n_aout)
        super().__init__(ishape, oshape, dtype)
        npdt, npct = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        self._sotf = np.asarray(sotf, npct) if self._with_conv else None
        idxs, ws = np.asarray(plan.idx), np.asarray(plan.w, npdt)
        wts = np.asarray(weights[:, : n_aout * self.srf : self.srf, :], npdt)
        wpsf = np.asarray(wpsf, npdt)
        nla, nlb = len(local_a), len(local_b)
        imshape = (len(alpha_axis), len(beta_axis))
        srf = self.srf
        with_conv = self._with_conv

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl)
            if with_conv:
                cube = fft.idft(fft.dft(cube) * self._sotf, imshape)
            local = bilinear.apply_plan(idxs, ws, cube).reshape(
                cube.shape[0], nla, nlb
            )
            windows = jnp.stack(
                [
                    local[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
                    for a0, b0 in zip(a0s, b0s)
                ]
            )
            windows = windows * wts[:, jnp.newaxis, :, :]
            return wblur.wblur_sum_beta_batched(windows, wpsf)

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroSigRLT(_SigRLBase):
    """y = Sig R L T a (reference SigRLT_Model.spectroSigRLT)."""

    _with_conv = False


class SpectroSigRLCT(_SigRLBase):
    """y = Sig R L C T a (reference SigRLCT_Model.spectroSigRLCT)."""

    _with_conv = True


class _ChannelModel(LinOp):
    """Shared wrapper: full Sig·R·L·S·C·T pipeline of one channel."""

    _gridding = "bilinear"

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        pointings: Optional[CoordList] = None,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        self.multi_pointing = pointings is not None
        if pointings is None:
            pointings = CoordList([Coord(0, 0)])
        srf = get_srf([instr.det_pix_size], step_degree * 3600)[0]
        self.channel = Channel(
            instr,
            np.asarray(alpha_axis),
            np.asarray(beta_axis),
            np.asarray(wavelength_axis),
            srf,
            CoordList(pointings),
            step_degree,
            dtype=dtype,
            gridding=self._gridding,
        )
        chan = self.channel
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = chan.oshape if self.multi_pointing else chan.oshape[1:]
        super().__init__(ishape, oshape, dtype)
        npdt, npct = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        self._sotf = np.asarray(sotf, npct)
        imshape = (len(alpha_axis), len(beta_axis))
        multi = self.multi_pointing

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl)
            blurred = fft.idft(fft.dft(cube) * self._sotf, imshape)
            xw = jax.lax.slice_in_dim(
                blurred, chan.wslice.start, chan.wslice.stop, axis=0
            )
            out = chan._forward_windowed(xw, chan._wpsf_dev)
            return out if multi else out[0]

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


class SpectroSigRLSCT1C(_ChannelModel):
    """Single-channel single-pointing y = Sig R L S C T a
    (reference SigRLSCT_Model.spectroSigRLSCT)."""


class SpectroSigRLSCT1C_NN(_ChannelModel):
    """NN-gridding variant (reference SigRLSCT_Model.spectroSigRLSCT_NN)."""

    _gridding = "nn"


class MO_SigRLSCT(_ChannelModel):
    """Multi-pointing single-channel model
    (reference MO_SigRLSCT_Model.spectroSigRLSCT)."""

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr,
        step_degree,
        pointings,
        dtype=jnp.float32,
    ):
        super().__init__(
            sotf,
            templates,
            alpha_axis,
            beta_axis,
            wavelength_axis,
            instr,
            step_degree,
            pointings=CoordList(pointings),
            dtype=dtype,
        )


class MO_SigRLSCT_shiftConv(LinOp):
    """Multi-pointing variant with the dither applied as a Fourier phase
    ramp on a single gridded FOV instead of per-pointing regridding
    (reference MO_SigRLSCT_Model.spectroSigRLSCT_corrected — body missing
    from the snapshot; reconstructed per SURVEY.md §7 hard-part 7)."""

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instr: IFU,
        step_degree: float,
        pointings,
        dtype=jnp.float32,
    ):
        templates = np.asarray(templates)
        pointings = CoordList(pointings).pix(step_degree)
        srf = get_srf([instr.det_pix_size], step_degree * 3600)[0]
        # channel with the origin pointing provides all static tables
        self.channel = Channel(
            instr,
            np.asarray(alpha_axis),
            np.asarray(beta_axis),
            np.asarray(wavelength_axis),
            srf,
            CoordList([Coord(0, 0)]),
            step_degree,
            dtype=dtype,
        )
        chan = self.channel
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(pointings),) + chan.oshape[1:]
        super().__init__(ishape, oshape, dtype)
        npdt, npct = _npdtypes(dtype)
        self._tpl = np.asarray(templates, npdt)
        self._sotf = np.asarray(sotf, npct)
        nla, nlb = chan.local_im_shape
        # per-pointing shift OTF on the local grid (cycle/step units)
        fa = np.fft.fftfreq(nla)[:, None]
        fb = np.fft.rfftfreq(nlb)[None, :]
        step = step_degree
        otfs = []
        for p in pointings:
            da = p.alpha / step
            db = p.beta / step
            shift = np.exp(-2j * np.pi * (fa * da + fb * db))
            otfs.append(np.asarray(chan.otf_combined * shift, npct))
        imshape = (len(alpha_axis), len(beta_axis))
        n_aout = chan.oshape[3]
        sb = chan.slit_shape[2]
        idx0, w0 = chan._plans_fwd_dev[0]
        wts = chan.slit_weights_sub
        wpsf = chan._wpsf_dev

        def fwd(x):
            cube = lmm.lmm_maps2cube(x, self._tpl)
            blurred = fft.idft(fft.dft(cube) * self._sotf, imshape)
            xw = jax.lax.slice_in_dim(
                blurred, chan.wslice.start, chan.wslice.stop, axis=0
            )
            gridded = bilinear.apply_plan(idx0, w0, xw).reshape(
                xw.shape[0], nla, nlb
            )
            spec = fft.dft(gridded)
            outs = []
            for otf in otfs:
                summed = fft.idft(spec * otf, (nla, nlb))
                windows = jnp.stack(
                    [
                        summed[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
                        for a0, b0 in zip(chan.slit_a_starts, chan.slit_b_starts)
                    ]
                )
                windows = windows * wts[:, jnp.newaxis, :, :]
                outs.append(wblur.wblur_sum_beta_batched(windows, wpsf))
            return jnp.stack(outs)

        self._fwd = jax.jit(fwd)

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


def MCMO_SigRLSCT_NN(
    sotf,
    templates,
    alpha_axis,
    beta_axis,
    wavelength_axis,
    instrs: List[IFU],
    step_degree: float,
    pointings,
    dtype=jnp.float32,
):
    """NN-gridding flagship (reference MCMO_SigRLSCT_Model.spectroSigRLSCT_NN)."""
    return MCMO_SigRLSCT(
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instrs,
        step_degree,
        pointings,
        dtype=dtype,
        gridding="nn",
    )


# ---------------------------------------------------------------------------
# Reference-name aliases (migration aid).  The reference instantiates each
# variant as `<X>_Model.spectro<X>(...)` (test_fw_ad.py:17-1026); these
# aliases let migrated code keep those constructor names.  The reference
# reuses the bare name `spectroSigRLSCT` across its single-channel / MO /
# MCMO modules — the flat namespace here keeps them distinct, with the
# module-qualified reference name noted per alias.
spectroT = SpectroT
spectroC = SpectroC
spectroCT = SpectroCT
spectroST = SpectroST
spectroSnearestT = SpectroSnearestT
spectroSCT = SpectroSCT
spectroLT = SpectroLT
spectroLST = SpectroLST
spectroMO_ST = SpectroMO_ST
spectroR = SpectroR
spectroRL = SpectroRL
spectroRLT = SpectroRLT
spectroSigRLT = SpectroSigRLT
spectroSigRLCT = SpectroSigRLCT
spectroSigRLSCT_1C = SpectroSigRLSCT1C        # SigRLSCT_Model.spectroSigRLSCT
spectroSigRLSCT_1C_NN = SpectroSigRLSCT1C_NN  # SigRLSCT_Model.spectroSigRLSCT_NN
spectroSigRLSCT_MO = MO_SigRLSCT              # MO_SigRLSCT_Model.spectroSigRLSCT
spectroSigRLSCT_corrected = MO_SigRLSCT_shiftConv  # ….spectroSigRLSCT_corrected
spectroSigRLSCT_MCMO = MCMO_SigRLSCT          # MCMO_SigRLSCT_Model.spectroSigRLSCT
spectroSigRLSCT_MCMO_NN = MCMO_SigRLSCT_NN    # ….spectroSigRLSCT_NN
# spectroSigRLSCT_MCMO IS the production flagship
# (`surfh_tpu.models.spectro.SpectroSigRLSCT`, imported above).
