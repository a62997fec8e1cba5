"""Single-wavelength 2-D MRS models: deconvolution of one λ plane.

Behavioural reference: `MRSBlurred` in
/root/reference/surfh/Models/spectro_blind.py:27-416 (rotated-FOV bilinear
gridding) and spectro_blind_rectangle.py:27-411 (unrotated nearest-index
window).  Same SigLSC pipeline as the 3-D channel but without the λ axis or
spectral blur: C (FFT PSF) → per-pointing S → SRF sum → per-slit L → β sum.

The design matches :mod:`surfh_tpu.models.channel`: static tables + one pure
jittable forward; the adjoint is the exact linear transpose.
"""

from __future__ import annotations

from math import ceil, floor
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bilinear, fft
from ..core.linop import LinOp
from ..instrument.geometry import Coord, CoordList, LocalFOV, get_srf
from ..instrument.ifu import IFU


class _Blind2DBase(LinOp):
    """Shared slit geometry for the 2-D models (no Slicer: single λ plane)."""

    def __init__(self, sotf, alpha_axis, beta_axis, instr: IFU, step_degree, pointings, dtype):
        self.sotf_host = np.asarray(sotf)
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.step_degree = float(step_degree)
        self.instr = instr
        self.pointings = pointings

        self.srf = get_srf([instr.det_pix_size], self.step_degree * 3600)[0]
        la, lb = instr.fov.local_coords(step_degree, 5 * step_degree, 5 * step_degree)
        self.local_alpha_axis, self.local_beta_axis = la, lb
        self.local_im_shape = (len(la), len(lb))

        ishape = (len(self.alpha_axis), len(self.beta_axis))
        self.slices_shape = (
            len(pointings),
            instr.n_slit,
            ceil(self.npix_slit_alpha_width / self.srf),
        )
        super().__init__(ishape, (int(np.prod(self.slices_shape)),), dtype)
        self.imshape = self.ishape

        # Static tables stay HOST NumPy: jit embeds them as program
        # constants (an eager `jnp.asarray` would upload them and then
        # fetch them back at trace time).  Same rule as channel.py.
        ctype = np.complex64 if dtype == jnp.float32 else np.complex128
        otf_sr = fft.box_otf_sr(self.srf, self.local_im_shape, np.complex128)[0]
        decalf = fft.half_srf_shift_otf(self.srf, self.local_im_shape, np.complex128)
        self._otf_sr = otf_sr
        self.decalf = decalf
        self.otf_combined = np.asarray(otf_sr * decalf, ctype)
        self.sotf = np.asarray(self.sotf_host, ctype)

        # slit windows
        self._build_slit_tables()
        self._forward_jit = jax.jit(self._forward_fn)
        self._transpose_fn = None

    # slit geometry (reference spectro_blind.py:85-190)
    @property
    def slit_alpha_width(self):
        return self.instr.fov.alpha_width

    @property
    def npix_slit_alpha_width(self) -> int:
        step = self.local_alpha_axis[1] - self.local_alpha_axis[0]
        return int(ceil(self.slit_alpha_width / 2 / step)) - int(
            floor(-self.slit_alpha_width / 2 / step)
        )

    @property
    def slit_beta_width(self):
        return self.instr.fov.beta_width / self.instr.n_slit

    @property
    def npix_slit_beta_width(self) -> int:
        return int(ceil(self.slit_beta_width / (self.beta_axis[1] - self.beta_axis[0])))

    def slit_local_fov(self, slit_idx: int) -> LocalFOV:
        return self.instr.slit_fov[slit_idx].local + self.instr.slit_shift[slit_idx]

    def get_slit_slices(self, slit_idx: int) -> Tuple[slice, slice]:
        slices = self.slit_local_fov(slit_idx).to_slices(
            self.local_alpha_axis, self.local_beta_axis
        )
        if (slices[1].stop - slices[1].start) > self.npix_slit_beta_width:
            fov = self.slit_local_fov(slit_idx)
            if abs(self.local_beta_axis[slices[1].stop] - fov.beta_end) > abs(
                self.local_beta_axis[slices[1].start] - fov.beta_start
            ):
                slices = (slices[0], slice(slices[1].start, slices[1].stop - 1))
            else:
                slices = (slices[0], slice(slices[1].start + 1, slices[1].stop))
        return slices

    def get_slit_weights(self, slit_idx: int, slices) -> np.ndarray:
        beta_step = self.local_beta_axis[1] - self.local_beta_axis[0]
        fov = self.slit_local_fov(slit_idx)
        sa = slices[0].stop - slices[0].start
        sb = slices[1].stop - slices[1].start
        weights = np.ones((sa, sb))
        sel = self.local_beta_axis[slices[1]]
        if sel[0] - beta_step / 2 < fov.beta_start:
            weights[:, 0] = 1 - abs(sel[0] - beta_step / 2 - fov.beta_start) / beta_step
        if sel[-1] + beta_step / 2 > fov.beta_end:
            weights[:, -1] = 1 - abs(sel[-1] + beta_step / 2 - fov.beta_end) / beta_step
        # neighbour-share rule (reference spectro_blind.py:149-167; note the
        # reference compares against npix_slit_beta_width here, not n_slit)
        if slit_idx > 0:
            if self.get_slit_slices(slit_idx - 1)[1].stop - 1 != slices[1].start:
                weights[:, 0] = 1
        if slit_idx < self.npix_slit_beta_width - 1 and slit_idx < self.instr.n_slit - 1:
            if slices[1].stop - 1 != self.get_slit_slices(slit_idx + 1)[1].start:
                weights[:, -1] = 1
        return weights

    def _build_slit_tables(self):
        shape0 = None
        a_starts, b_starts, weights = [], [], []
        for s in range(self.instr.n_slit):
            sl = self.get_slit_slices(s)
            shp = (sl[0].stop - sl[0].start, sl[1].stop - sl[1].start)
            if shape0 is None:
                shape0 = shp
            elif shp != shape0:
                raise ValueError(f"slit {s} window {shp} != {shape0}")
            a_starts.append(sl[0].start)
            b_starts.append(sl[1].start)
            weights.append(self.get_slit_weights(s, sl))
        self.slit_shape = shape0
        self.slit_a_starts = np.asarray(a_starts, np.int32)
        self.slit_b_starts = np.asarray(b_starts, np.int32)
        n_aout = self.slices_shape[2]
        w = np.stack(weights)
        npdtype = np.float32 if self.dtype == jnp.float32 else np.float64
        self.slit_weights_sub = np.asarray(
            w[:, : n_aout * self.srf : self.srf, :], npdtype)

    # pipeline pieces ---------------------------------------------------
    def _grid(self, blurred, p_idx):
        raise NotImplementedError

    def _forward_fn(self, x, sotf=None):
        """One λ plane's SigLSC forward.  `sotf` overrides the plane's OTF —
        pass it to batch the model over a λ-stack (see :class:`DeconvCube`)."""
        n_aout = self.slices_shape[2]
        srf = self.srf
        nla, nlb = self.local_im_shape
        sb = self.slit_shape[1]
        if sotf is None:
            sotf = self.sotf
        blurred = fft.idft(fft.dft(x) * sotf, self.ishape)
        per_pointing = []
        for p_idx in range(len(self.pointings)):
            gridded = self._grid(blurred, p_idx)
            summed = fft.idft(fft.dft(gridded) * self.otf_combined, (nla, nlb))
            windows = jnp.stack(
                [
                    summed[a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
                    for a0, b0 in zip(self.slit_a_starts, self.slit_b_starts)
                ]
            )
            windows = windows * self.slit_weights_sub
            per_pointing.append(jnp.sum(windows, axis=2))
        return jnp.stack(per_pointing).ravel()

    def forward(self, x):
        return self._forward_jit(jnp.asarray(x, self.dtype).reshape(self.ishape))

    def forward_fn(self, x):
        return self._forward_fn(x)

    def data_to_img(self, data) -> np.ndarray:
        """Weighted co-add of the detector data back to the sky (init aid;
        reference spectro_blind.py:238-…): β/SRF-duplicate each slit, scatter,
        reverse-grid, then average pointings where covered."""
        y = np.asarray(data).reshape(self.slices_shape)
        n_aout = self.slices_shape[2]
        scale = self.npix_slit_beta_width * self.srf
        cum = np.zeros((len(self.pointings),) + self.imshape)

        def one_pointing(x, p_idx):
            # S → SRF sum → L → β sum, *without* the C step (the reference's
            # data_to_img stops before the PSF adjoint)
            nla, nlb = self.local_im_shape
            gridded = self._grid(x, p_idx)
            summed = fft.idft(fft.dft(gridded) * self.otf_combined, (nla, nlb))
            windows = jnp.stack(
                [
                    summed[a0 : a0 + n_aout * self.srf : self.srf, b0 : b0 + self.slit_shape[1]]
                    for a0, b0 in zip(self.slit_a_starts, self.slit_b_starts)
                ]
            )
            return jnp.sum(windows * self.slit_weights_sub, axis=2)

        for p_idx in range(len(self.pointings)):
            yw = jnp.asarray(y[p_idx] / scale, self.dtype)
            primal = jax.ShapeDtypeStruct(self.ishape, self.dtype)
            img = jax.linear_transpose(lambda x: one_pointing(x, p_idx), primal)(yw)[0]
            cum[p_idx] = np.asarray(img)
        counts = np.sum(cum != 0, axis=0)
        total = np.sum(cum, axis=0)
        return np.divide(total, counts, out=np.zeros_like(total), where=counts != 0)


class MRSBlurred(_Blind2DBase):
    """Rotated-FOV variant: bilinear gridding per pointing."""

    def __init__(self, sotf, alpha_axis, beta_axis, instr: IFU, step_degree, pointings, dtype=jnp.float32):
        self._pointings_raw = pointings
        super().__init__(sotf, alpha_axis, beta_axis, instr, step_degree, pointings, dtype)
        self.plans = []
        for pointing in self.pointings:
            fov = self.instr.fov + pointing
            ga, gb = fov.local2global(self.local_alpha_axis, self.local_beta_axis)
            self.plans.append(
                bilinear.bilinear_plan(self.alpha_axis, self.beta_axis, bilinear.grid_points(ga, gb))
            )
        npdtype = np.float32 if self.dtype == jnp.float32 else np.float64
        self._plans_dev = [
            (np.asarray(p.idx), np.asarray(p.w, npdtype)) for p in self.plans
        ]
        self._forward_jit = jax.jit(self._forward_fn)  # rebuild with plans

    def _grid(self, blurred, p_idx):
        idx, w = self._plans_dev[p_idx]
        return bilinear.apply_plan(idx, w, blurred[jnp.newaxis])[0].reshape(self.local_im_shape)


class MRSBlurredRectangle(_Blind2DBase):
    """Unrotated variant: the local window is a nearest-index crop of the
    global grid centered on the pointing (reference
    spectro_blind_rectangle.py:286-307)."""

    def __init__(self, sotf, alpha_axis, beta_axis, instr: IFU, step_degree, pointings, dtype=jnp.float32):
        super().__init__(sotf, alpha_axis, beta_axis, instr, step_degree, pointings, dtype)
        self.windows = []
        aw, bw = self.local_im_shape
        for pointing in self.pointings:
            ia = int(np.abs(self.alpha_axis - pointing.alpha).argmin())
            ib = int(np.abs(self.beta_axis - pointing.beta).argmin())
            self.windows.append(
                (slice(ia - aw // 2, ia + aw // 2 + 1), slice(ib - bw // 2, ib + bw // 2 + 1))
            )
        self._forward_jit = jax.jit(self._forward_fn)

    def _grid(self, blurred, p_idx):
        sa, sb = self.windows[p_idx]
        return blurred[sa, sb]


class DeconvCube(LinOp):
    """λ-stack no-rotation cube deconvolution (BASELINE config 2).

    The reference runs its 2-D deconvolution one detector wavelength at a
    time (scripts/deconvolution_mrs_noRotation.py:149-216 builds one
    `MRSBlurred` per chosen λ slice with that slice's PSF).  Here the λ
    planes are independent, identically-shaped programs — so the whole
    stack is ONE `vmap` of the 2-D forward over (plane, OTF) pairs: a single
    compiled batched program whose FFTs/matmuls run W planes deep, instead
    of W scalar re-runs.

    `base` supplies the slit/pointing geometry (an :class:`MRSBlurredRectangle`
    for noRotation semantics, or :class:`MRSBlurred` for the rotated FOV);
    `sotf_stack` is the per-λ OTF, shape (W,) + rfft2 shape.
    """

    def __init__(self, base: _Blind2DBase, sotf_stack):
        self.base = base
        ctype = np.complex64 if base.dtype == jnp.float32 else np.complex128
        self.sotf_stack = np.asarray(sotf_stack, ctype)
        w = int(self.sotf_stack.shape[0])
        self.n_lambda = w
        self.cube_oshape = (w,) + base.slices_shape
        super().__init__(
            (w,) + tuple(base.ishape),
            (w * int(np.prod(base.slices_shape)),),
            base.dtype,
        )
        self._forward_jit = jax.jit(self._forward_fn)
        self._adjoint_jit = None

    def _forward_fn(self, x):
        per_l = jax.vmap(self.base._forward_fn)(x, self.sotf_stack)
        return per_l.ravel()

    def forward_fn(self, x):
        return self._forward_fn(x)

    def forward(self, x):
        return self._forward_jit(jnp.asarray(x, self.dtype).reshape(self.ishape))

    def adjoint_fn(self, y):
        primal = jax.ShapeDtypeStruct(self.ishape, self.dtype)
        return jax.linear_transpose(self._forward_fn, primal)(
            jnp.asarray(y, self.dtype).reshape(self.oshape)
        )[0]

    def adjoint(self, y):
        if self._adjoint_jit is None:
            self._adjoint_jit = jax.jit(self.adjoint_fn)
        return self._adjoint_jit(y)
