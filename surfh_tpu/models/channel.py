"""One MRS band over all its pointings: the SigRLS(C) channel pipeline.

Behavioural reference: `Channel`
(/root/reference/surfh/Models/spectroModelChannel.py:26-436).  The design
replaces the reference's per-pointing/per-slit Python-object pipeline with a
single pure jittable function over static precomputed tables:

* gridding (S): precomputed bilinear gather plan per pointing
  (construction-time, float64) — 4-term flattened gather at runtime;
* SRF accumulation (the `otf_sr · decalf` trick): batched unitary rfft2 ×
  per-frequency transfer function;
* slicing (L): static strided window gathers, α subsampled *before* the
  spectral blur (commutes — srf× cheaper);
* spectral blur + β integration (Sig·R): one batched GEMM
  [λ', λ·β] @ [λ·β, α'] per slit stack.

The exact adjoint is `jax.linear_transpose` of the forward; the reference's
approximate reverse-interpolation adjoint is kept available (`adjoint_interp`)
for output-parity studies.
"""

from __future__ import annotations

import os
from math import ceil
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import platform_policy
from ..core import bilinear, fft, linop, numpy_ref, wblur, wblur_banded
from ..core.precision import gemm_precision
from ..instrument.geometry import Coord, CoordList
from ..instrument.ifu import IFU
from .slicer import Slicer

# Max per-grid-pixel contributor count for which the padded-gather transpose
# plan stays the fast layout; above it (edge-clamping degeneracy on small sky
# grids) the sorted-COO scatter form is used instead.
TPLAN_DENSE_CMAX = 32


class Channel:
    """Forward model of one IFU band across its dither pointings.

    Parameters mirror the reference Channel: the band `instr`, the global sky
    axes, the global wavelength axis, the channel's integer SRF, the pointing
    list and the common super-resolution step (degrees).
    """

    def __init__(
        self,
        instr: IFU,
        alpha_axis: np.ndarray,
        beta_axis: np.ndarray,
        wavel_axis: np.ndarray,
        srf: int,
        pointings: CoordList,
        step_degree: float,
        dtype=jnp.float32,
        gridding: str = "bilinear",
        wblur_impl: str = "dense",
        wblur_band_rtol: float = 0.0,
        slit_unroll: bool = True,
        pointing_scan: Optional[bool] = None,
    ):
        if wblur_impl not in ("dense", "banded"):
            raise ValueError(f"unknown wblur_impl {wblur_impl!r}")
        self.wblur_impl = wblur_impl
        # unrolled static slit slices fuse best; the compact vmap/fori form
        # keeps the graph O(1) in n_slit for compile-bound flagship-scale
        # builds.
        self.slit_unroll = bool(slit_unroll)
        # support threshold (relative to max) for the banded kernel: the sinc²
        # response has algebraic tails, so banding truncates ~rtol of the
        # response mass in exchange for ~W/LB fewer FLOPs/bytes.  0 keeps the
        # full window (banding then only helps strongly windowed responses).
        self.wblur_band_rtol = float(wblur_band_rtol)
        self._band_plan = None
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.step_degree = float(step_degree)
        self.global_wavelength_axis = np.asarray(wavel_axis, np.float64)
        self.srf = int(srf)
        self.dtype = dtype

        self.instr = instr.pix(self.step_degree)
        self.pointings = pointings.pix(self.step_degree)
        # Pointing structure: unrolled pointings mean constant gather tables
        # and full cross-pointing XLA fusion; the scan keeps the graph O(1)
        # in n_pointing (each iteration dynamic-slices its pointing's
        # stacked tables into the loop body).  The default follows
        # config.platform_policy; override with the explicit flag or
        # SURFH_POINTING_SCAN=0/1.
        if pointing_scan is None:
            env = os.environ.get("SURFH_POINTING_SCAN")
            if env:  # empty string = unset (documented contract: 0/1)
                pointing_scan = env != "0"
            else:
                pointing_scan = (
                    len(self.pointings)
                    > platform_policy().max_unrolled_pointings
                )
        self.pointing_scan = bool(pointing_scan)

        local_alpha_axis, local_beta_axis = self.instr.fov.local_coords(
            step_degree, alpha_margin=5 * step_degree, beta_margin=5 * step_degree
        )
        self.local_alpha_axis = local_alpha_axis
        self.local_beta_axis = local_beta_axis

        self.slicer = Slicer(
            self.instr,
            wavelength_axis=self.global_wavelength_axis,
            alpha_axis=self.alpha_axis,
            beta_axis=self.beta_axis,
            local_alpha_axis=local_alpha_axis,
            local_beta_axis=local_beta_axis,
            srf=self.srf,
        )

        self.ishape = (
            len(self.global_wavelength_axis),
            len(self.alpha_axis),
            len(self.beta_axis),
        )
        self.oshape = (
            len(self.pointings),
            self.instr.n_slit,
            len(self.instr.wavel_axis),
            ceil(self.slicer.npix_slit_alpha_width / self.srf),
        )
        self.local_im_shape = (len(local_alpha_axis), len(local_beta_axis))
        self.imshape = (len(self.alpha_axis), len(self.beta_axis))
        self.instr_cube_shape = (
            self.wslice.stop - self.wslice.start,
            len(self.alpha_axis),
            len(self.beta_axis),
        )
        self.local_cube_shape = (
            len(self.global_wavelength_axis),
            len(local_alpha_axis),
            len(local_beta_axis),
        )
        self.slices_shape = (len(self.pointings), self.instr.n_slit, self.oshape[3])

        # --- static tables ------------------------------------------------
        # All construction-time constants are kept as *host* NumPy arrays:
        # jit embeds them directly (the flagship-scale ones ride as jit
        # arguments instead, see host_tables).
        npdtype = np.float32 if dtype == jnp.float32 else np.float64
        npctype = np.complex64 if dtype == jnp.float32 else np.complex128
        self._npdtype = npdtype
        # SRF box-sum OTF × half-SRF phase shift, combined once.
        otf_sr = fft.box_otf_sr(self.srf, self.local_im_shape, np.complex128)
        decalf = fft.half_srf_shift_otf(self.srf, self.local_im_shape, np.complex128)
        self._otf_sr = otf_sr
        self.decalf = decalf
        self.otf_combined = np.asarray(otf_sr * decalf, npctype)
        self.otf_combined_conj = np.asarray((otf_sr * decalf).conj(), npctype)

        # Spectral PSF over the channel's λ window.  The dirac variant is
        # only consumed by the data re-projection utilities
        # (sliceToCube/realData_*), so it builds lazily — the sinc² margin
        # evaluation is the single most expensive construction stage
        # (~12 s/channel at flagship scale on the 1-vCPU host).
        self.wpsf = self._build_wpsf("mrs")
        self._wpsf_dirac = None
        self._wpsf_dev = np.asarray(self.wpsf, npdtype)

        # Per-pointing bilinear gather plans (cube grid → rotated local grid)
        # and the reverse plans (local grid → cube grid) for the
        # reference-parity adjoint and data re-projection utilities.
        if gridding not in ("bilinear", "nn"):
            raise ValueError(f"unknown gridding mode {gridding!r}")
        self.gridding = gridding
        if gridding == "nn":
            from ..core.nearest import nearest_plan

            _plan = lambda aa, bb, pts, **kw: nearest_plan(aa, bb, pts, **kw)
        else:
            _plan = bilinear.bilinear_plan
        self._plan_builder = _plan
        self.plans_fwd: List[bilinear.BilinearPlan] = []
        for pointing in self.pointings:
            fov = self.instr.fov + pointing
            ga, gb = fov.local2global(self.local_alpha_axis, self.local_beta_axis)
            self.plans_fwd.append(
                _plan(self.alpha_axis, self.beta_axis, bilinear.grid_points(ga, gb))
            )
        # reverse plans (local grid → cube grid, interpolated at EVERY global
        # pixel — the expensive direction) serve only the reference-parity
        # adjoint and the data re-projection utilities: built lazily.
        self._plans_rev = None
        self._plans_rev_dev_cache = None
        self._plans_fwd_dev = [
            (np.asarray(p.idx), np.asarray(p.w, npdtype)) for p in self.plans_fwd
        ]
        # Stacked per-pointing tables [P, 4, Npts] for the lax.scan pipeline:
        # scanning over pointings keeps the compiled graph O(1) in n_pointing
        # (the flagship is 12 bands × 4 pointings — unrolling every pointing
        # of every band made the 12-band adjoint a ~30-min XLA compile).
        self._plans_fwd_stack = (
            np.stack([i for i, _ in self._plans_fwd_dev]),
            np.stack([w for _, w in self._plans_fwd_dev]),
        )
        # FOV bounding box of the instrument footprint: the union over
        # pointings of every nonzero-weight forward-gather source pixel
        # (identical to the transpose plans' destination set — the composed
        # plan, the matmul conv and the staged transpose all restrict to it).
        na_g, nb_g = self.imshape
        _nz = [p.idx[p.w != 0] for p in self.plans_fwd]
        _nz = [i for i in _nz if i.size]
        if _nz:
            _flat = np.concatenate([i.reshape(-1) for i in _nz])
            a0, a1 = int((_flat // nb_g).min()), int((_flat // nb_g).max()) + 1
            b0, b1 = int((_flat % nb_g).min()), int((_flat % nb_g).max()) + 1
        else:  # degenerate: no in-grid contribution
            a0, a1, b0, b1 = 0, 1, 0, 1
        ha, wb = a1 - a0, b1 - b0
        self._tbbox = (a0, b0, ha, wb)
        # The staged transpose plans (dense padded-gather or sorted-COO —
        # see _ensure_tplans) are only needed when the composed plan is NOT
        # in use, and their construction (csr sorts + C·N stacks at flagship
        # scale) is a large share of model-build time: built lazily.
        self._tplans_built = False
        self._tplans_fwd_list = None
        self._tplans_fwd_stack_cache = None
        self._tplan_kind_cache = None

        # Slit window tables, α pre-subsampled by the SRF.
        a_starts, b_starts, weights = self.slicer.slit_tables()
        self.slit_a_starts = a_starts
        self.slit_b_starts = b_starts
        n_aout = self.oshape[3]
        self.slit_weights_sub = np.asarray(
            weights[:, : n_aout * self.srf : self.srf, :], npdtype
        )
        self.slit_shape = self.slicer.get_slit_shape()
        # int32 device copies for the vmapped window gather / fori_loop scatter
        self._a_starts_dev = np.asarray(a_starts, np.int32)
        self._b_starts_dev = np.asarray(b_starts, np.int32)

        # --- direct SRF box-sum ------------------------------------------
        # `otf_combined` is the transfer function of "sum srf consecutive α
        # rows, half-SRF-shifted": away from circular-wrap edges that's a
        # plain reshape-sum, removing one FFT pair per pointing in the
        # forward AND the adjoint.  Calibrate the row offset once and verify
        # exactness; fall back to the FFT path when windows touch the edges.
        self._box_offset = self._calibrate_box_offset()

        # --- composed window plan -----------------------------------------
        # When the direct box-sum is exact, the whole middle chain
        # (bilinear gridding → SRF box-sum → per-slit windowing) is one
        # static linear gather; compose it at construction into a single
        # C·srf-tap plan per pointing (core/bilinear.py ComposedWindowPlan).
        # Eliminates the materialized [W, nla, nlb] local cube, the α-srf
        # broadcast and the sequential slit scatter in BOTH directions —
        # the same taps, the same math, one gather (fwd) / one sorted
        # scatter (adj).  SURFH_COMPOSED_GRIDDING=0 restores the staged
        # pipeline.
        self._composed_stack = None
        self._composed_t_stack = None
        self._composed_t_stack_mp = None
        self._composed_t_layered = False
        self._composed_t_impl = "coo"
        if (
            self._box_offset is not None
            and os.environ.get("SURFH_COMPOSED_GRIDDING", "1") != "0"
        ):
            n_aout = self.oshape[3]
            sb = self.slit_shape[2]
            cplans = [
                bilinear.compose_window_plan(
                    p, self.slit_a_starts, self.slit_b_starts,
                    self._box_offset, self.srf, n_aout, sb,
                    self.local_im_shape, self._tbbox, npdtype,
                )
                for p in self.plans_fwd
            ]
            n_patch = self._tbbox[2] * self._tbbox[3]
            _mmax = max(c.csrc.shape[0] for c in cplans)

            def _padc(a, fill):
                return np.pad(a, (0, _mmax - a.shape[0]), constant_values=fill)

            self._composed_stack = (
                np.stack([c.idx for c in cplans]),
                np.stack([c.w for c in cplans]),
                np.stack([_padc(c.csrc, 0) for c in cplans]),
                np.stack([_padc(c.cw, 0) for c in cplans]),
                np.stack([_padc(c.cdst, n_patch - 1) for c in cplans]),
            )
            # Transpose representation: "banded" (default) packs the
            # geometrically local tap majority into dense [tb, sw] weight
            # blocks consumed as ONE batched matmul over contiguous
            # source windows (the per-tap row gather disappears),
            # "rows"/"layered" spell it as bucketed row gathers / dense
            # prefix adds, "coo" restores the single sorted scatter.  All four are the exact transpose (same taps,
            # only f64 reduction-order noise — tests pin 1e-13 agreement).
            # The layer count is the max taps per patch pixel — ≤ ~10 at
            # production scales, but grids much smaller than the FOV clamp
            # thousands of taps onto border pixels (e.g. band 4 on a 41²
            # test grid: 2840); past SURFH_COMPOSED_T_LMAX the unrolled
            # rows/layered graphs would explode compile time, so those
            # fall back to COO (banded is layer-count-independent).
            n_layers = max(len(c.layers) for c in cplans)
            lmax = int(os.environ.get("SURFH_COMPOSED_T_LMAX", "16"))
            impl = os.environ.get("SURFH_COMPOSED_T_IMPL", "banded")
            if impl not in ("banded_mp", "banded", "rows", "layered", "coo"):
                raise ValueError(
                    f"SURFH_COMPOSED_T_IMPL={impl!r}: "
                    "expected banded_mp|banded|rows|layered|coo"
                )
            if n_layers > lmax and impl not in ("banded", "banded_mp"):
                impl = "coo"
            if impl == "banded_mp" and self.wblur_impl == "banded":
                # the pointing-summed transpose fuses the wblur_t GEMM into
                # its batched matmul, which the banded wblur replaces — the
                # combination would silently fall back to the staged path.
                # Demote to the per-pointing banded form, which composes
                # with the banded wblur.
                import warnings

                warnings.warn(
                    "SURFH_COMPOSED_T_IMPL=banded_mp is incompatible with "
                    "wblur_impl='banded' (the mp form owns the wblur_t "
                    "GEMM); using the per-pointing 'banded' transpose",
                    stacklevel=3,
                )
                impl = "banded"
            self._composed_t_impl = impl
            self._composed_t_layered = impl not in (
                "coo", "banded", "banded_mp")
            self._composed_t_stack_mp = None
            if impl == "banded_mp":
                # pointing-summed banded transpose: one shared destination
                # permutation, pointing-concatenated weight blocks
                # (K = P·sw), the unperm take / tail scatter paid once per
                # application instead of once per pointing
                # (bilinear.banded_mp_from_coo).
                tb = int(os.environ.get("SURFH_BANDED_TB", "256"))
                sw = int(os.environ.get("SURFH_BANDED_SW", "128"))
                n_patch = cplans[0].patch_shape[0] * cplans[0].patch_shape[1]
                n_out = int(np.prod(cplans[0].out_shape))
                self._composed_t_stack_mp = bilinear.banded_mp_from_coo(
                    [(c.csrc, c.cw, c.cdst) for c in cplans],
                    n_patch, n_out, tb=tb, sw=sw, dtype=npdtype,
                )
            elif impl == "banded":
                # banded-matmul transpose: dense [tb, sw] weight blocks over
                # source-sorted destination rows + a sorted non-local tail
                # (bilinear.banded_from_coo).  Two passes: block counts and
                # tail lengths differ per pointing, so build against the
                # maxima and zero-pad (padding rows/taps add nothing).
                tb = int(os.environ.get("SURFH_BANDED_TB", "256"))
                sw = int(os.environ.get("SURFH_BANDED_SW", "128"))
                n_patch = cplans[0].patch_shape[0] * cplans[0].patch_shape[1]
                n_out = int(np.prod(cplans[0].out_shape))
                raw = [
                    bilinear.banded_from_coo(
                        c.csrc, c.cw, c.cdst, n_patch, n_out,
                        tb=tb, sw=sw, dtype=npdtype,
                    )
                    for c in cplans
                ]
                nb_max = max(r[2].shape[0] for r in raw)
                k_max = max(r[3].shape[0] for r in raw)
                parts = [[] for _ in range(6)]
                for c, r in zip(cplans, raw):
                    if r[2].shape[0] < nb_max:
                        r = bilinear.banded_from_coo(
                            c.csrc, c.cw, c.cdst, n_patch, n_out,
                            tb=tb, sw=sw, dtype=npdtype, nb_total=nb_max,
                        )
                    linv_b, idx, wb, osrc, ow, odst = r
                    pad = k_max - osrc.shape[0]
                    parts[0].append(linv_b)
                    parts[1].append(idx)
                    parts[2].append(wb)
                    parts[3].append(np.pad(osrc, (0, pad)))
                    parts[4].append(np.pad(ow, (0, pad)))
                    parts[5].append(
                        np.pad(odst, (0, pad),
                               constant_values=nb_max * tb)
                    )
                self._composed_t_stack = tuple(
                    np.stack(p) for p in parts
                )
            elif self._composed_t_layered:
                t_ks = [
                    max(
                        (c.layers[k][0].shape[0] if k < len(c.layers) else 0)
                        for c in cplans
                    )
                    for k in range(n_layers)
                ]
                # per-pointing layers zero-padded to common sizes: padded
                # taps carry w=0 (add nothing) and untouched linv entries
                # land on all-zero acc rows, so shapes unify exactly
                parts = [np.stack([c.linv for c in cplans])]
                for k in range(n_layers):
                    srcs, ws = [], []
                    for c in cplans:
                        if k < len(c.layers):
                            s, w = c.layers[k]
                        else:
                            s = np.zeros(0, np.int32)
                            w = np.zeros(0, npdtype)
                        pad = t_ks[k] - s.shape[0]
                        srcs.append(np.pad(s, (0, pad)))
                        ws.append(np.pad(w.astype(npdtype), (0, pad)))
                    parts.append(np.stack(srcs))
                    parts.append(np.stack(ws))
                if impl == "rows":
                    # bucketed ROW form (the default): pack the prefix
                    # layers into ≈3 padded buckets consumed as one fused
                    # take+einsum each — same taps, L accumulator passes
                    # collapse to the bucket count (the flagship adjoint's
                    # dominant memory-traffic term)
                    groups = bilinear.bucket_layers(t_ks)
                    rows_parts = [parts[0]]
                    srcs_s, ws_s = parts[1::2], parts[2::2]
                    for grp in groups:
                        tg = t_ks[grp[0]]
                        src_g = np.zeros(
                            (len(self.pointings), len(grp), tg), np.int32
                        )
                        wgt_g = np.zeros(
                            (len(self.pointings), len(grp), tg), npdtype
                        )
                        for j, k in enumerate(grp):
                            src_g[:, j, : t_ks[k]] = srcs_s[k]
                            wgt_g[:, j, : t_ks[k]] = ws_s[k]
                        rows_parts.append(src_g)
                        rows_parts.append(wgt_g)
                    self._composed_t_stack = tuple(rows_parts)
                else:
                    self._composed_t_stack = tuple(parts)
            else:
                self._composed_t_stack = self._composed_stack[2:]

        # --- pointing-batched composed tables -----------------------------
        # All pointings gather from the same source patch, so the composed
        # gather and its layered transpose can fold across the pointing axis
        # on the host: ONE gather + ONE wblur GEMM (forward) and one take per
        # transpose LAYER (adjoint) serve every pointing — ~P× fewer op
        # instances per compiled program; same taps and per-destination
        # accumulation order (only the GEMM reduction blocking can differ,
        # ~1e-15 rel).  It was a net loss inside the fused flagship programs
        # on the previous accelerator (the folded transpose either strides
        # the accumulator update or wrecks gather locality), so it ships
        # OFF; SURFH_POINTING_BATCH=1 opts in.
        self.pointing_batch = bool(
            self._composed_stack is not None
            # the batched fold assumes the LAYERED table layout
            and getattr(self, "_composed_t_impl", None) == "layered"
            and self.wblur_impl != "banded"
            and os.environ.get("SURFH_POINTING_BATCH", "0") == "1"
        )
        self._composed_batch = None
        self._composed_t_batch = None
        if self.pointing_batch:
            n_out = self.oshape[1] * self.oshape[3] * self.slit_shape[2]
            self._composed_batch = bilinear.batch_composed_plan(
                self._composed_stack[0], self._composed_stack[1]
            )
            self._composed_t_batch = bilinear.batch_composed_layered_t(
                self._composed_t_stack[0], self._composed_t_stack[1:], n_out
            )

        # --- pointing-CONCATENATED banded transpose + batched fwd gather --
        # In the UNROLLED pointing mode every (channel, pointing) pays its own gather /
        # scatter / take instances.  This mode shares one instruction per
        # site across the pointing axis at the INDEX level — offset index
        # tables into pointing-concatenated sources, no lane-axis relayout
        # (the banded_mp mistake) — and batches the forward composed
        # gather + wblur GEMM over pointings.  SURFH_POINTING_CAT=0/1.
        self.pointing_cat = bool(
            self._composed_stack is not None
            and self._composed_t_impl == "banded"
            and self.wblur_impl != "banded"
            and not self.pointing_scan
            and os.environ.get("SURFH_POINTING_CAT", "0") == "1"
        )
        self._composed_t_cat = None
        if self.pointing_cat:
            n_out = self.oshape[1] * self.oshape[3] * self.slit_shape[2]
            if self._composed_batch is None:
                self._composed_batch = bilinear.batch_composed_plan(
                    self._composed_stack[0], self._composed_stack[1]
                )
            self._composed_t_cat = bilinear.banded_cat_from_stack(
                *self._composed_t_stack, n_out
            )

        self._forward_jit = jax.jit(self._forward_fn)
        self._adjoint_jit = None
        self._adjoint_interp_jit = None

    # ------------------------------------------------------------------
    @property
    def wslice(self) -> slice:
        """λ window of the global axis covered by this channel (0.1 μm margin)."""
        return self.instr.wslice(self.global_wavelength_axis, 0.1)

    @property
    def beta_step(self) -> float:
        return self.beta_axis[1] - self.beta_axis[0]

    @property
    def wpsf_dirac(self) -> np.ndarray:
        """Nearest-sample re-projection response (built on first use)."""
        if self._wpsf_dirac is None:
            self._wpsf_dirac = self._build_wpsf("dirac")
        return self._wpsf_dirac

    @property
    def plans_rev(self) -> List[bilinear.BilinearPlan]:
        """Reverse (local → global) interpolation plans, built on first use
        — they evaluate at every global grid pixel (the expensive
        direction) and serve only the reference-parity adjoint and the
        data re-projection utilities."""
        if self._plans_rev is None:
            self._plans_rev = []
            for pointing in self.pointings:
                fov = self.instr.fov + pointing
                la, lb = fov.global2local(self.alpha_axis, self.beta_axis)
                self._plans_rev.append(
                    self._plan_builder(
                        self.local_alpha_axis,
                        self.local_beta_axis,
                        bilinear.grid_points(la, lb),
                        fill_out_of_bounds=True,
                    )
                )
        return self._plans_rev

    @property
    def _plans_rev_dev(self):
        if self._plans_rev_dev_cache is None:
            self._plans_rev_dev_cache = [
                (np.asarray(p.idx), np.asarray(p.w, self._npdtype))
                for p in self.plans_rev
            ]
        return self._plans_rev_dev_cache

    def _ensure_tplans(self):
        """Build the staged transpose plans on first use.

        Two layouts:
        - "dense" padded gather (TransposePlan): C = max contributions per
          grid pixel rows, applied as C weighted gathers — scatter-free,
          fastest when C is the natural 4-corner bound;
        - "csr" sorted-COO (CSRTransposePlan): O(M ≈ 4P) triples + ONE
          sorted scatter-add.  When the sky grid is much smaller than the
          instrument FOV, edge clamping drives C into the thousands and the
          dense form degenerates (C·N tables, C unrolled HLO gathers); CSR
          stays flat.
        Weights are cast to the model dtype like the forward plans.  Both
        stacks are restricted to the FOV bbox (`_tbbox`): the padded-gather
        transpose otherwise pays its C gathers for every grid pixel and the
        CSR form scatters into the full grid; the affine index remap
        preserves the CSR dst ordering (row-major is monotone under a
        window crop)."""
        if self._tplans_built:
            return
        npdtype = self._npdtype
        na_g, nb_g = self.imshape
        a0, b0, ha, wb = self._tbbox
        a1, b1 = a0 + ha, b0 + wb
        _csr = [bilinear.csr_transpose_plan(p) for p in self.plans_fwd]
        _cmax = max(
            int(np.bincount(t.dst, minlength=1).max()) if t.dst.size else 1
            for t in _csr
        )
        self._tplan_kind_cache = "dense" if _cmax <= TPLAN_DENSE_CMAX else "csr"
        if self._tplan_kind_cache == "dense":
            self._tplans_fwd_list = [
                bilinear.TransposePlan(t.idx, np.asarray(t.w, npdtype), t.shape)
                for t in (bilinear.transpose_plan(p) for p in self.plans_fwd)
            ]
            # pad C to the max over pointings (w=0 rows are inert)
            _cpad = max(t.idx.shape[0] for t in self._tplans_fwd_list)
            ti = np.stack(
                [
                    np.pad(t.idx, ((0, _cpad - t.idx.shape[0]), (0, 0)))
                    for t in self._tplans_fwd_list
                ]
            )
            tw_ = np.stack(
                [
                    np.pad(t.w, ((0, _cpad - t.w.shape[0]), (0, 0)))
                    for t in self._tplans_fwd_list
                ]
            )
            npt, cpd = ti.shape[0], ti.shape[1]
            ti = ti.reshape(npt, cpd, na_g, nb_g)[:, :, a0:a1, b0:b1]
            tw_ = tw_.reshape(npt, cpd, na_g, nb_g)[:, :, a0:a1, b0:b1]
            self._tplans_fwd_stack_cache = (
                np.ascontiguousarray(ti.reshape(npt, cpd, ha * wb)),
                np.ascontiguousarray(tw_.reshape(npt, cpd, ha * wb)),
            )
        else:
            self._tplans_fwd_list = [
                bilinear.CSRTransposePlan(
                    t.src, np.asarray(t.w, npdtype), t.dst, t.shape
                )
                for t in _csr
            ]
            # pad M to the max over pointings; padding entries carry w=0 and
            # dst=N−1 (keeps dst ascending for the sorted scatter)
            _mmax = max(t.src.shape[0] for t in self._tplans_fwd_list)
            _n_grid = int(np.prod(self._tplans_fwd_list[0].shape))

            def _padm(a, fill):
                return np.pad(a, (0, _mmax - a.shape[0]), constant_values=fill)

            tsrc = np.stack([_padm(t.src, 0) for t in self._tplans_fwd_list])
            tw_ = np.stack([_padm(t.w, 0) for t in self._tplans_fwd_list])
            tdst = np.stack([_padm(t.dst, _n_grid - 1) for t in self._tplans_fwd_list])
            rows = tdst // nb_g
            cols = tdst % nb_g
            loc = (np.clip(rows - a0, 0, ha - 1) * wb
                   + np.clip(cols - b0, 0, wb - 1)).astype(np.int32)
            # zero-weight padding entries (dst = N-1) clip into the bbox
            self._tplans_fwd_stack_cache = (tsrc, tw_, loc)
        self._tplans_built = True

    @property
    def _tplans_fwd(self):
        self._ensure_tplans()
        return self._tplans_fwd_list

    @property
    def _tplan_kind(self) -> str:
        self._ensure_tplans()
        return self._tplan_kind_cache

    @property
    def _tplans_fwd_stack(self):
        self._ensure_tplans()
        return self._tplans_fwd_stack_cache

    @property
    def n_wslice(self) -> int:
        return self.wslice.stop - self.wslice.start

    def _calibrate_box_offset(self):
        """Row offset such that the strided slit windows of the SRF FFT
        convolution equal a direct reshape-sum of srf consecutive rows.
        Returns None (→ FFT path) if no in-bounds offset reproduces it."""
        nla, nlb = self.local_im_shape
        srf = self.srf
        n_aout = self.oshape[3]
        sb = self.slit_shape[2]
        a0 = int(self.slit_a_starts[0])
        b0 = int(self.slit_b_starts[0])
        rng = np.random.default_rng(0)
        g = rng.standard_normal((2, nla, nlb))
        otf = self._otf_sr * self.decalf  # complex128
        summed = np.fft.irfftn(
            np.fft.rfftn(g, axes=(-2, -1), norm="ortho") * otf,
            s=(nla, nlb),
            axes=(-2, -1),
            norm="ortho",
        )
        ref = summed[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
        for off in range(-2 * srf, 2 * srf + 1):
            start = a0 + off
            if start < 0 or start + n_aout * srf > nla:
                continue
            direct = (
                g[:, start : start + n_aout * srf, b0 : b0 + sb]
                .reshape(2, n_aout, srf, sb)
                .sum(axis=2)
            )
            if np.allclose(direct, ref, rtol=1e-9, atol=1e-9):
                if all(
                    0 <= int(a) + off and int(a) + off + n_aout * srf <= nla
                    for a in self.slit_a_starts
                ):
                    return off
        return None

    def _build_wpsf(self, kind: str) -> np.ndarray:
        """wpsf [λ_det, λ_window, β_slit] (reference spectroModelChannel.py:133-155)."""
        length = self.slicer.npix_slit_beta_width
        beta_in_slit = np.arange(0, length) * self.beta_step
        return self.instr.spectral_psf(
            beta_in_slit - np.mean(beta_in_slit),
            self.global_wavelength_axis[self.wslice],
            arcsec2micron=self.instr.wavel_step / self.instr.det_pix_size,
            type=kind,
        )

    def host_tables(self) -> dict:
        """Large per-channel arrays as a host pytree, for the "tables as jit
        arguments" mode.

        jit embeds closed-over arrays — NumPy *and* device — as dense HLO
        constants, so at flagship scale (~4 GB of wpsf/plan/OTF tables across
        12 bands, BASELINE.md) the compiled program would be GB-sized and
        could not be cached compactly.  Passing this dict as an argument
        keeps the HLO small; values live in device memory once (device_put
        by the caller) and are shared across forward/adjoint/solver
        compiles."""
        t = {
            "wpsf": self._wpsf_dev,
            "slit_w": self.slit_weights_sub,
        }
        if self.pointing_batch:
            # pointing-batched composed mode: only the folded tables ship
            # (the stacked per-pointing variants go unused — same data,
            # different layout, so shipping both would double the upload)
            t["cgrid_b"] = self._composed_batch
            t["cgrid_t_b"] = self._composed_t_batch[1:]
        elif self.pointing_cat:
            # pointing-concatenated banded mode: batched forward gather +
            # index-offset concatenated transpose tables (the stacked
            # per-pointing variants go unused)
            t["cgrid_b"] = self._composed_batch
            t["cgrid_ct"] = self._composed_t_cat
        elif self._composed_stack is not None:
            # composed mode: the staged gather/transpose tables go unused —
            # omitting them saves their device residency and upload
            # (they are replicated per device in the sharded modes)
            t["cgrid"] = self._composed_stack[:2]
            if self._composed_t_stack_mp is not None:
                t["cgrid_mt"] = self._composed_t_stack_mp
            else:
                t["cgrid_t"] = self._composed_t_stack
        else:
            t["plan_idx"] = self._plans_fwd_stack[0]
            t["plan_w"] = self._plans_fwd_stack[1]
            t["tplan"] = self._tplans_fwd_stack
        return t

    def band_plan(self):
        """Banded-contraction plan of this channel's wpsf (built lazily)."""
        if self._band_plan is None:
            self._band_plan = wblur_banded.build_band_plan(
                self.wpsf, rel_eps=self.wblur_band_rtol
            )
        return self._band_plan

    def band_plan_t(self):
        """Banded plan of the transpose contraction (built lazily)."""
        if getattr(self, "_band_plan_t", None) is None:
            self._band_plan_t = wblur_banded.build_band_plan_t(
                self.wpsf, rel_eps=self.wblur_band_rtol
            )
        return self._band_plan_t

    # ------------------------------------------------------------------
    # pure forward pipeline (works on the windowed cube [W, Na, Nb])
    def _forward_windowed(self, xw, wpsf):
        """Dispatching forward: the Sig·R contraction runs dense (one GEMM)
        or banded (slab gathers exploiting the wpsf's λ-support)."""
        return self._forward_windowed_impl(xw, wpsf, self.wblur_impl)

    def _forward_windowed_dense(self, xw, wpsf):
        """Dense-only forward — the reference the adjoints are derived from."""
        return self._forward_windowed_impl(xw, wpsf, "dense")

    # -- slit windowing ----------------------------------------------------
    # Two spellings with identical semantics:
    #  * unrolled static slices (default) — trivial ops XLA fuses into the
    #    surrounding pipeline (slice/stack and the window adds fuse with the
    #    FFT/matmul stages around them);
    #  * one vmapped dynamic_slice / fori_loop of dynamic-update-slices —
    #    O(1) graph size in n_slit, for compile-bound flagship-scale builds
    #    (`slit_unroll=False`).
    def _gather_slit_windows(self, img, a_off: int, rows: int):
        """All slit windows of a local image stack: img [W, nla, nlb] →
        [S, W, rows, sb].  `a_off` shifts every α start (the calibrated
        box-sum offset); construction guarantees the shifted windows are in
        bounds, so the dynamic_slice form never clamps."""
        sb = self.slit_shape[2]
        W_ = img.shape[0]
        if self.slit_unroll:
            return jnp.stack(
                [
                    img[:, a0 + a_off : a0 + a_off + rows, b0 : b0 + sb]
                    for a0, b0 in zip(
                        self.slit_a_starts.tolist(), self.slit_b_starts.tolist()
                    )
                ]
            )

        def one(a0, b0):
            zero = jnp.zeros((), a0.dtype)
            return jax.lax.dynamic_slice(
                img, (zero, a0 + a_off, b0), (W_, rows, sb)
            )

        return jax.vmap(one)(self._a_starts_dev, self._b_starts_dev)

    def _scatter_slit_windows_t(self, up, a_off: int, nla_out: int):
        """Exact transpose of :meth:`_gather_slit_windows`: accumulate the
        per-slit windows up [S, W, rows, sb] back into a zero [W, nla_out,
        nlb] stack.  Adjacent slits share one β edge column, so updates must
        accumulate (slice-adds, or a sequential fori_loop of
        dynamic-update-slices in the compact form)."""
        nlb = self.local_im_shape[1]
        S, W_, rows, sb = up.shape
        out = jnp.zeros((W_, nla_out, nlb), up.dtype)
        if self.slit_unroll:
            for s, (a0, b0) in enumerate(
                zip(self.slit_a_starts.tolist(), self.slit_b_starts.tolist())
            ):
                out = out.at[
                    :, a0 + a_off : a0 + a_off + rows, b0 : b0 + sb
                ].add(up[s])
            return out

        def body(s, acc):
            a0 = jnp.asarray(self._a_starts_dev)[s] + a_off
            b0 = jnp.asarray(self._b_starts_dev)[s]
            zero = jnp.zeros((), a0.dtype)
            cur = jax.lax.dynamic_slice(acc, (zero, a0, b0), (W_, rows, sb))
            return jax.lax.dynamic_update_slice(acc, cur + up[s], (zero, a0, b0))

        return jax.lax.fori_loop(0, S, body, out)

    def _forward_one_pointing(self, xw, wpsf, impl, idx, w, slit_w=None,
                              cgrid=None, bbox_in=False):
        """One pointing's S·L·R·Sig pipeline: windowed cube → [S, λ', α].

        `slit_w` overrides the baked slit-weight table — pass it (with idx/w
        sourced from :meth:`host_tables`) to keep every large array a traced
        jit argument instead of an embedded HLO constant (the flagship-scale
        mode).  `cgrid` = (cidx, cw) runs the composed
        gridding∘box-sum∘window gather (same math, one gather stage)."""
        n_aout = self.oshape[3]
        srf = self.srf
        nla, nlb = self.local_im_shape
        banded = impl == "banded" and wpsf is self._wpsf_dev
        off = self._box_offset
        W_ = xw.shape[0]
        if slit_w is None:
            slit_w = self.slit_weights_sub
        if cgrid is not None:
            # `bbox_in` is the explicit caller contract (symmetric with the
            # adjoint's `bbox_out`): True = xw is already the FOV-bbox patch
            # (the matmul-conv tabled path), False = full sky grid.
            a0, b0, ha, wb = self._tbbox
            patch = xw if bbox_in else xw[:, a0 : a0 + ha, b0 : b0 + wb]
            win = bilinear.apply_composed_plan(
                cgrid[0], cgrid[1], patch.reshape(W_, ha * wb)
            )
            S = self.oshape[1]
            windows = jnp.transpose(
                win.reshape(W_, S, n_aout, self.slit_shape[2]), (1, 0, 2, 3)
            )
        elif off is not None:
            gridded = bilinear.apply_plan(idx, w, xw).reshape(W_, nla, nlb)
            # direct SRF box-sum: gather srf·n_aout rows per slit, fold the
            # srf axis by reshape and sum — no FFT pair needed
            windows = self._gather_slit_windows(gridded, off, n_aout * srf)
            windows = windows.reshape(-1, W_, n_aout, srf, windows.shape[3]).sum(
                axis=3
            )
        else:
            gridded = bilinear.apply_plan(idx, w, xw).reshape(W_, nla, nlb)
            summed = fft.idft(fft.dft(gridded) * self.otf_combined, (nla, nlb))
            # strided α read: gather the covering rows then subsample
            windows = self._gather_slit_windows(
                summed, 0, (n_aout - 1) * srf + 1
            )[:, :, ::srf, :]
        windows = windows * slit_w[:, jnp.newaxis, :, :]
        if banded:
            return wblur_banded.wblur_sum_beta_banded(
                windows, self.band_plan()
            ).astype(xw.dtype)
        return wblur.wblur_sum_beta_batched(windows, wpsf)

    def _forward_windowed_impl(self, xw, wpsf, impl, tables=None,
                               bbox_in=False):
        n_pt = len(self.pointings)
        cb = None
        if impl != "banded":
            if tables is not None:
                cb = tables.get("cgrid_b")
                slit_wb = tables["slit_w"] if cb is not None else None
            elif self.pointing_batch or self.pointing_cat:
                cb = self._composed_batch
                slit_wb = self.slit_weights_sub
        if cb is not None:
            # pointing-batched composed path: ONE gather + ONE wblur GEMM
            # for all pointings (same linear map as the scanned spelling)
            a0, b0, ha, wb = self._tbbox
            W_ = xw.shape[0]
            patch = xw if bbox_in else xw[:, a0 : a0 + ha, b0 : b0 + wb]
            win = bilinear.apply_composed_plan(
                cb[0], cb[1], patch.reshape(W_, ha * wb)
            )
            S, A, sb = self.oshape[1], self.oshape[3], self.slit_shape[2]
            w5 = win.reshape(W_, n_pt, S, A, sb) * slit_wb[None, None]
            return wblur.wblur_sum_beta_pointings(w5, wpsf)
        if tables is None:
            slit_w = None
            comp = (
                self._composed_stack[:2] if self._composed_stack is not None
                else None
            )
            stack = None if comp is not None else self._plans_fwd_stack
        else:
            slit_w = tables["slit_w"]
            comp = tables.get("cgrid")
            stack = (
                None if comp is not None
                else (tables["plan_idx"], tables["plan_w"])
            )
        if not self.pointing_scan:
            # unrolled: constant gather tables, full cross-pointing fusion
            return jnp.stack(
                [
                    self._forward_one_pointing(
                        xw, wpsf, impl,
                        None if stack is None else stack[0][p],
                        None if stack is None else stack[1][p],
                        slit_w,
                        cgrid=None if comp is None
                        else (comp[0][p], comp[1][p]),
                        bbox_in=bbox_in,
                    )
                    for p in range(n_pt)
                ]
            )

        def body(_, plan):
            if comp is not None:
                idx = w = None
                cgrid = (plan[0], plan[1])
            else:
                idx, w = plan[0], plan[1]
                cgrid = None
            return None, self._forward_one_pointing(
                xw, wpsf, impl, idx, w, slit_w, cgrid=cgrid, bbox_in=bbox_in
            )

        xs = tuple(comp) if comp is not None else tuple(stack)
        _, per_pointing = jax.lax.scan(body, None, xs)
        return per_pointing

    def _forward_fn(self, cube):
        """cube [L, Na, Nb] → detector blocks [P, S, λ_det, α_out]."""
        xw = jax.lax.slice_in_dim(cube, self.wslice.start, self.wslice.stop, axis=0)
        return self._forward_windowed(xw, self._wpsf_dev)

    # ------------------------------------------------------------------
    def forward(self, cube):
        """Apply the channel forward model; returns [P, S, λ_det, α_out]."""
        return self._forward_jit(jnp.asarray(cube, self.dtype))

    def adjoint(self, y):
        """Exact transpose of :meth:`forward`: [P, S, λ_det, α_out] → cube."""
        if self._adjoint_jit is None:
            primal = jax.ShapeDtypeStruct(self.ishape, self.dtype)

            def dense_fwd(cube):
                xw = jax.lax.slice_in_dim(
                    cube, self.wslice.start, self.wslice.stop, axis=0
                )
                return self._forward_windowed_dense(xw, self._wpsf_dev)

            transpose = linop.build_transpose(dense_fwd, primal)
            self._adjoint_jit = jax.jit(lambda y: transpose(y)[0])
        return self._adjoint_jit(jnp.asarray(y, self.dtype).reshape(self.oshape))

    def adjoint_windowed(self, y):
        """Exact transpose restricted to the λ window: → [W, Na, Nb]."""
        primal = jax.ShapeDtypeStruct(
            (self.n_wslice,) + self.ishape[1:], self.dtype
        )
        transpose = linop.build_transpose(
            lambda xw: self._forward_windowed_dense(xw, self._wpsf_dev), primal
        )
        return transpose(jnp.asarray(y, self.dtype).reshape(self.oshape))[0]

    def _adjoint_windowed_fast(self, y):
        """Hand-written exact transpose of :meth:`_forward_windowed`.

        Same math as the derived transpose but with the two scatter hot
        spots restructured: the spectral-blur transpose is one GEMM per
        pointing, and the gridding transpose is a presorted
        segment-sum instead of XLA's generic 4-point scatter.
        """
        return self._adjoint_windowed_fast_impl(y, self.n_wslice, self._wpsf_dev)

    def _adjoint_windowed_fast_impl(self, y, W: int, wpsf, tables=None,
                                    bbox_out: bool = False):
        """Scanned-over-pointings body of the fast adjoint.  `W` / `wpsf` are
        parameters so λ-sharded callers can run it on a window sub-span;
        `tables` (from :meth:`host_tables`) sources the transpose-plan and
        slit-weight arrays as traced arguments instead of HLO constants.

        `bbox_out=True` returns the FOV-bbox patch [W, ha, wb] without
        padding it into the global grid — for callers whose next stage (the
        bbox-restricted matmul conv transpose) consumes the patch directly."""
        n_aout = self.oshape[3]
        srf = self.srf
        nla, nlb = self.local_im_shape
        sb = self.slit_shape[2]
        K = wpsf.shape[0]
        S = self.oshape[1]
        slit_w = self.slit_weights_sub if tables is None else tables["slit_w"]
        banded = self.wblur_impl == "banded" and wpsf is self._wpsf_dev
        # one explicit GEMM [S·A, K] @ [K, W·B] (an einsum spelling of the
        # same contraction can get a worse operand layout)
        wp2d = wpsf.reshape(K, W * sb)
        off = self._box_offset

        cmt = None
        if self._composed_t_impl == "banded_mp" and not banded:
            cmt = (tables.get("cgrid_mt") if tables is not None
                   else self._composed_t_stack_mp)
        if cmt is not None:
            # pointing-summed banded transpose: ONE wblur_t GEMM batched
            # over pointings, then bilinear.apply_composed_plan_banded_mp_t
            # — the pointing sum rides inside the banded matmul's
            # contraction and the unperm take / tail scatter run once.
            n_pt = len(self.pointings)
            a0, b0, ha, wb = self._tbbox
            y2d = jnp.transpose(y, (0, 1, 3, 2)).reshape(
                n_pt * S * n_aout, K)
            win_t = jax.lax.dot_general(
                y2d, wp2d, (((1,), (0,)), ((), ())),
                preferred_element_type=y.dtype,
                precision=gemm_precision(),
            ).reshape(n_pt, S, n_aout, W, sb)
            win_t = win_t * slit_w[None, :, :, None, :]
            vals = jnp.transpose(win_t, (0, 3, 1, 2, 4)).reshape(
                n_pt, W, -1)
            patch = bilinear.apply_composed_plan_banded_mp_t(
                *cmt, vals).reshape(W, ha, wb)
            if bbox_out:
                return patch
            na_g, nb_g = self.imshape
            return jnp.pad(
                patch,
                ((0, 0), (a0, na_g - a0 - ha), (b0, nb_g - b0 - wb)),
            )

        cct = None
        if not banded and self._composed_t_impl == "banded":
            if tables is not None:
                cct = tables.get("cgrid_ct")
            elif self.pointing_cat:
                cct = self._composed_t_cat
        if cct is not None:
            # pointing-concatenated banded transpose: ONE wblur_t GEMM
            # batched over pointings, then ONE window gather + batched
            # banded matmul + one sorted tail scatter + one unperm take for
            # ALL pointings (index-offset tables; same taps and order as
            # the per-pointing banded form, pointing sum in the final take).
            n_pt = len(self.pointings)
            a0, b0, ha, wb = self._tbbox
            y2d = jnp.transpose(y, (0, 1, 3, 2)).reshape(
                n_pt * S * n_aout, K)
            win_t = jax.lax.dot_general(
                y2d, wp2d, (((1,), (0,)), ((), ())),
                preferred_element_type=y.dtype,
                precision=gemm_precision(),
            ).reshape(n_pt, S, n_aout, W, sb)
            win_t = win_t * slit_w[None, :, :, None, :]
            vals = jnp.transpose(win_t, (0, 3, 1, 2, 4)).reshape(
                n_pt, W, -1)
            patch = bilinear.apply_composed_plan_banded_cat_t(
                *cct, vals).reshape(W, ha, wb)
            if bbox_out:
                return patch
            na_g, nb_g = self.imshape
            return jnp.pad(
                patch,
                ((0, 0), (a0, na_g - a0 - ha), (b0, nb_g - b0 - wb)),
            )

        ctb = None
        if not banded:
            if tables is not None:
                ctb = tables.get("cgrid_t_b")
            elif self.pointing_batch:
                ctb = self._composed_t_batch[1:]
        if ctb is not None:
            # pointing-batched composed transpose: ONE wblur_t GEMM and one
            # take per layered-prefix layer serve all pointings; the final
            # sum over the pointing axis is the adjoint accumulation.
            # Same taps and order as the scanned spelling.
            n_pt = len(self.pointings)
            a0, b0, ha, wb = self._tbbox
            linv_b, *rest = ctb
            layers = list(zip(rest[0::2], rest[1::2]))
            y2d = jnp.transpose(y, (0, 1, 3, 2)).reshape(n_pt * S * n_aout, K)
            win_t = jax.lax.dot_general(
                y2d, wp2d, (((1,), (0,)), ((), ())),
                preferred_element_type=y.dtype,
                precision=gemm_precision(),
            ).reshape(n_pt, S, n_aout, W, sb).transpose(0, 1, 3, 2, 4)
            win_t = win_t * slit_w[None, :, None, :, :]
            vals = jnp.transpose(win_t, (2, 0, 1, 3, 4)).reshape(W, -1)
            patches = bilinear.apply_composed_plan_layered_t_batched(
                n_pt, linv_b, layers, vals
            )
            patch = patches.sum(axis=0).T.reshape(W, ha, wb)
            if bbox_out:
                return patch
            na_g, nb_g = self.imshape
            return jnp.pad(
                patch,
                ((0, 0), (a0, na_g - a0 - ha), (b0, nb_g - b0 - wb)),
            )

        def one_pointing(yp, tplan, cgrid_t=None):
            # transpose of wblur_sum_beta, all slits at once
            if banded:
                win_t = wblur_banded.wblur_sum_beta_t_banded(
                    yp, self.band_plan_t()
                ).astype(yp.dtype)
            else:
                y2d = jnp.transpose(yp, (0, 2, 1)).reshape(S * n_aout, K)
                win_t = jax.lax.dot_general(
                    y2d, wp2d, (((1,), (0,)), ((), ())),
                    preferred_element_type=yp.dtype,
                    precision=gemm_precision(),
                ).reshape(S, n_aout, W, sb)
                win_t = jnp.transpose(win_t, (0, 2, 1, 3))
            win_t = win_t * slit_w[:, jnp.newaxis, :, :]
            if cgrid_t is not None:
                # composed transpose: window outputs → bbox patch, either
                # layered prefix adds (default) or one sorted scatter —
                # both the exact transpose of the composed gather
                a0, b0, ha, wb = self._tbbox
                vals = jnp.transpose(win_t, (1, 0, 2, 3)).reshape(W, -1)
                if self._composed_t_impl == "banded":
                    patch = bilinear.apply_composed_plan_banded_t(
                        *cgrid_t, vals
                    ).reshape(W, ha, wb)
                elif self._composed_t_impl == "rows":
                    linv, *rest = cgrid_t
                    buckets = list(zip(rest[0::2], rest[1::2]))
                    patch = bilinear.apply_composed_plan_rows_t(
                        linv, buckets, vals
                    ).reshape(W, ha, wb)
                elif self._composed_t_layered:
                    linv, *rest = cgrid_t
                    layers = list(zip(rest[0::2], rest[1::2]))
                    patch = bilinear.apply_composed_plan_layered_t(
                        linv, layers, vals
                    ).reshape(W, ha, wb)
                else:
                    patch = bilinear.apply_composed_plan_t(
                        *cgrid_t, vals, ha * wb
                    ).reshape(W, ha, wb)
                if bbox_out:
                    return patch
                na_g, nb_g = self.imshape
                return jnp.pad(
                    patch,
                    ((0, 0), (a0, na_g - a0 - ha), (b0, nb_g - b0 - wb)),
                )
            if off is not None:
                # transpose of the direct box-sum: broadcast each window row
                # over its srf source rows, contiguous block adds, no FFT
                up = jnp.broadcast_to(
                    win_t[:, :, :, jnp.newaxis, :], (S, W, n_aout, srf, sb)
                ).reshape(S, W, n_aout * srf, sb)
                gridded_t = self._scatter_slit_windows_t(up, off, nla)
            else:
                # α-upsample as a pad (stride becomes a reshaped axis), then
                # contiguous block adds and the conjugate SRF convolution
                up = jnp.zeros((S, W, n_aout, srf, sb), yp.dtype)
                up = up.at[:, :, :, 0, :].set(win_t).reshape(S, W, n_aout * srf, sb)
                # α padded so the contiguous blocks never clip (the strided
                # forward read stops inside the grid; ceil(sa/srf)·srf may not)
                nla_pad = max(
                    nla,
                    max(int(a0) + n_aout * srf for a0 in self.slit_a_starts),
                )
                summed_t = self._scatter_slit_windows_t(up, 0, nla_pad)[:, :nla, :]
                gridded_t = fft.idft(
                    fft.dft(summed_t) * jnp.conj(self.otf_combined), (nla, nlb)
                )
            a0, b0, ha, wb = self._tbbox
            if self._tplan_kind == "dense":
                patch = bilinear.apply_transpose_plan_arrays(
                    *tplan, gridded_t.reshape(W, -1), (ha, wb)
                )
            else:
                patch = bilinear.apply_csr_transpose_arrays(
                    *tplan, gridded_t.reshape(W, -1), (ha, wb)
                )
            if bbox_out:
                return patch
            na_g, nb_g = self.imshape
            return jnp.pad(
                patch,
                ((0, 0), (a0, na_g - a0 - ha), (b0, nb_g - b0 - wb)),
            )

        out_shape = (
            (W, self._tbbox[2], self._tbbox[3]) if bbox_out
            else (W,) + self.imshape
        )
        if tables is not None:
            if ("cgrid_tz" in tables or "cgrid_mtz" in tables
                    or "cgrid_ctz" in tables):
                raise ValueError(
                    "banded transpose tables arrived packed (cgrid_tz/"
                    "cgrid_mtz/cgrid_ctz): run "
                    "SpectroSigRLSCT.materialize_otf/device_tables to rebuild "
                    "the dense weight blocks on device before applying"
                )
            comp_t = tables.get("cgrid_t")
            stack = comp_t if comp_t is not None else tables["tplan"]
        else:
            comp_t = (
                self._composed_t_stack if self._composed_stack is not None
                else None
            )
            stack = comp_t if comp_t is not None else self._tplans_fwd_stack
        if not self.pointing_scan:
            out = jnp.zeros(out_shape, y.dtype)
            for p_idx in range(len(self.pointings)):
                tp = tuple(t[p_idx] for t in stack)
                out = out + (
                    one_pointing(y[p_idx], None, cgrid_t=tp)
                    if comp_t is not None
                    else one_pointing(y[p_idx], tp)
                )
            return out

        def body(acc, xs):
            yp, *tp = xs
            if comp_t is not None:
                return acc + one_pointing(yp, None, cgrid_t=tuple(tp)), None
            return acc + one_pointing(yp, tuple(tp)), None

        out, _ = jax.lax.scan(
            body,
            jnp.zeros(out_shape, y.dtype),
            (y,) + tuple(stack),
        )
        return out

    # ------------------------------------------------------------------
    # reference-parity adjoint (approximate reverse-interp gridding_t)
    def _adjoint_interp_fn(self, y):
        """Reverse of the reference adjoint semantics
        (spectroModelChannel.py:234-264): β-repeat, wblur_t, slit scatter,
        conj OTF, reverse bilinear interpolation onto the global grid."""
        n_aout = self.oshape[3]
        srf = self.srf
        nla, nlb = self.local_im_shape
        W = self.n_wslice
        sa, sb = self.slit_shape[1], self.slit_shape[2]
        wpsf_c = self._wpsf_dev  # real wpsf: conj == identity
        out = jnp.zeros((W,) + self.imshape, self.dtype)
        for p_idx, (idx, w) in enumerate(self._plans_rev_dev):
            local_cube = jnp.zeros((W, nla, nlb), self.dtype)
            for s in range(self.instr.n_slit):
                # y[p, s] : [λ_det, α_out] → repeat over β → wblur_t → [W, α_out, β]
                over = jnp.repeat(y[p_idx, s][:, :, jnp.newaxis], sb, axis=2)
                blurred_t = wblur.wblur_t(over, wpsf_c)
                # α upsample: place rows at strided positions
                full = jnp.zeros((W, sa, sb), self.dtype)
                full = full.at[:, : n_aout * srf : srf, :].set(blurred_t)
                a0 = int(self.slit_a_starts[s])
                b0 = int(self.slit_b_starts[s])
                weights = self.slit_weights_sub[s]  # β-only weights, α-invariant
                wfull = jnp.zeros((sa, sb), self.dtype)
                wfull = wfull.at[: n_aout * srf : srf, :].set(weights)
                # reference applies the *full* α-resolution weights; they are
                # α-invariant so broadcast the first subsampled row
                wrow = self.slit_weights_sub[s][0][jnp.newaxis, :]
                local_cube = local_cube.at[:, a0 : a0 + sa, b0 : b0 + sb].add(
                    full * wrow[jnp.newaxis, :, :]
                )
            sum_t = fft.idft(fft.dft(local_cube) * self.otf_combined_conj, (nla, nlb))
            degridded = bilinear.apply_plan(idx, w, sum_t).reshape(
                W, self.imshape[0], self.imshape[1]
            )
            out = out + degridded
        return out

    def adjoint_interp(self, y):
        """Reference-parity (approximate) adjoint; returns the λ-window cube."""
        if self._adjoint_interp_jit is None:
            self._adjoint_interp_jit = jax.jit(self._adjoint_interp_fn)
        return self._adjoint_interp_jit(jnp.asarray(y, self.dtype).reshape(self.oshape))

    # ------------------------------------------------------------------
    # data ↔ cube utilities (dirac-wpsf re-projection; reference :266-336)
    def sliceToCube(self, data):
        """Re-project detector data of pointing 0 into a full-axis cube using
        the dirac spectral response (visualization / initialization aid)."""
        y = np.asarray(data).reshape(self.oshape)
        n_aout = self.oshape[3]
        srf = self.srf
        nla, nlb = self.local_im_shape
        W = self.n_wslice
        sa, sb = self.slit_shape[1], self.slit_shape[2]
        wpsf = self.wpsf_dirac
        local_cube = np.zeros((W, nla, nlb))
        for s in range(self.instr.n_slit):
            over = np.repeat(y[0, s][:, :, np.newaxis], sb, axis=2)
            blurred_t = np.einsum("kab,klb->lab", over, wpsf)
            full = np.zeros((W, sa, sb))
            full[:, : n_aout * srf : srf, :] = blurred_t
            local_cube += self.slicer.slicing_t(full, s, (W, nla, nlb))
        sum_t = np.fft.irfftn(
            np.fft.rfftn(local_cube, axes=(-2, -1), norm="ortho")
            * (self._otf_sr.conj() * self.decalf.conj()),
            s=(nla, nlb),
            axes=(-2, -1),
            norm="ortho",
        )
        plan = self.plans_rev[0]
        degridded = numpy_ref.apply_plan(plan, sum_t).reshape(
            W, self.imshape[0], self.imshape[1]
        )
        out = np.zeros((len(self.global_wavelength_axis),) + self.imshape)
        out[self.wslice] += degridded
        return out

    def realData_cubeToSlice(self, cube):
        """Project a λ-window cube to detector slices without spectral blur
        (β-sum only; reference :303-309)."""
        cube = np.asarray(cube)
        n_aout = self.oshape[3]
        plan = self.plans_fwd[0]
        # Coord(0,0) pointing: re-plan the ungathered FOV
        fov = self.instr.fov + Coord(0, 0)
        ga, gb = fov.local2global(self.local_alpha_axis, self.local_beta_axis)
        plan0 = bilinear.bilinear_plan(
            self.alpha_axis, self.beta_axis, bilinear.grid_points(ga, gb)
        )
        gridded = numpy_ref.apply_plan(plan0, cube).reshape(
            cube.shape[0], *self.local_im_shape
        )
        slices = np.zeros(self.oshape[1:])
        for s in range(self.instr.n_slit):
            sliced = self.slicer.slicing(gridded, s)[:, : n_aout * self.srf : self.srf, :]
            slices[s] = sliced.sum(axis=2)
        return slices

    def realData_sliceToCube(self, slices, cube_dim):
        """β-duplicate detector slices back to a cube (reference :311-336)."""
        slices = np.asarray(slices)
        nla, nlb = self.local_im_shape
        W = cube_dim[0]
        gridded = np.zeros((W, nla, nlb))
        for s in range(self.instr.n_slit):
            sl = self.slicer.get_slit_slices(s)
            sa = sl[0].stop - sl[0].start
            sb = sl[1].stop - sl[1].start
            tmp = (
                np.repeat(slices[s][:, :, np.newaxis], self.slicer.npix_slit_beta_width, axis=2)
                / self.slicer.npix_slit_beta_width
            )
            sliced = np.zeros((W, sa, sb))
            sliced[:, : W * self.srf : self.srf] = tmp[:, : sliced[:, :: self.srf].shape[1]]
            gridded += self.slicer.slicing_t(sliced, s, (W, nla, nlb))
        sum_t = np.fft.irfftn(
            np.fft.rfftn(gridded, axes=(-2, -1), norm="ortho") * self._otf_sr.conj(),
            s=(nla, nlb),
            axes=(-2, -1),
            norm="ortho",
        )
        fov = self.instr.fov + Coord(0, 0)
        la, lb = fov.global2local(self.alpha_axis, self.beta_axis)
        plan0 = bilinear.bilinear_plan(
            self.local_alpha_axis,
            self.local_beta_axis,
            bilinear.grid_points(la, lb),
            fill_out_of_bounds=True,
        )
        return numpy_ref.apply_plan(plan0, sum_t).reshape(W, *self.imshape)
