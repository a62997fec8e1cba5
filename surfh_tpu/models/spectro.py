"""The flagship fusion operator: y = Σ R L S C T x over all bands/pointings.

Behavioural reference: `spectroSigRLSCT`
(/root/reference/surfh/Models/spectroModel.py:39-338).  Accelerator design:

* one jitted pure forward over the whole multi-channel model — T (matmul),
  C (batched unitary rfft2 × sotf), then each channel's windowed pipeline;
* the adjoint is the exact `jax.linear_transpose` of that function (the
  per-channel λ-window scatter-adds of the reference fall out automatically);
* all per-channel static tables built once at construction.

Output layout matches the reference: a flat vector concatenating per-channel
4-D blocks [n_pointing, n_slit, n_λdet, n_αdet] (`_idx` cumsum).
"""

from __future__ import annotations

import os
import warnings
from math import ceil
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import platform_policy
from ..core import bilinear, fft, lmm
from ..core.linop import LinOp
from ..instrument.geometry import CoordList, get_srf
from ..instrument.ifu import IFU
from .channel import Channel


class SpectroSigRLSCT(LinOp):
    """Multi-channel multi-observation spectro-imaging forward model.

    Parameters
    ----------
    sotf:
        Non-unitary spatial OTF [Nλ, Na, Nb//2+1] (wavelength-dependent PSF).
    templates:
        LMM spectral templates [n_tpl, Nλ], or None to work on cubes directly.
    alpha_axis, beta_axis:
        Global sky axes (degrees).
    wavelength_axis:
        Global cube λ axis (μm).
    instrs:
        List of `IFU` bands.
    step_degree:
        Common super-resolution step (degrees).
    pointings:
        Per-channel `CoordList` of dither pointings.
    """

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instrs: List[IFU],
        step_degree: float,
        pointings,
        dtype=jnp.float32,
        gridding: str = "bilinear",
        wblur_impl: str = "dense",
        wblur_band_rtol: float = 0.0,
        window_local: bool = False,
        conv_impl: str = "auto",
        conv_freq_rtol: float = 0.0,
        psf_stack=None,
        conv_precision: str = "highest",
        conv_rank_rtol: float = 0.0,
    ):
        # Flagship-scale mode: evaluate T·C per channel λ-window and pass all
        # large tables (sotf, templates, wpsf, gather plans) as jit ARGUMENTS
        # instead of closed-over constants.  jit inlines closures as dense HLO
        # constants, so at the reference's real problem size (cube ≈ 3879λ ×
        # 501², sotf ≈ 3.9 GB complex64 — scripts/main_fusion.py:34-39) the
        # constant-embedding program is GB-sized and cannot be compiled or
        # cached; the tabled program's HLO stays KBs.  The math is
        # identical: the spatial FFT conv (C) is per-λ-plane, and the LMM (T)
        # is per-λ, so slicing the window before T·C commutes exactly.
        self.window_local = bool(window_local)
        # Spatial-conv backend for the window-local path: "fft" (XLA FFT) or
        # "matmul" (DFT matmuls, f32-class accuracy 7e-6; exact in float64.
        # PERF.md "matmul-DFT conv").  "auto" follows config.platform_policy.
        if conv_impl == "auto":
            conv_impl = platform_policy().conv_impl
        if conv_impl not in ("fft", "matmul"):
            raise ValueError(f"unknown conv_impl {conv_impl!r}")
        self.conv_impl = conv_impl
        # Frequency-support truncation of the matmul conv: drop DFT bins
        # where the OTF magnitude is below `conv_freq_rtol`·max (PSFs are
        # band-limited — diffraction-limited optics exactly, Gaussians to
        # ~1e-7 well inside Nyquist — so high-frequency stages multiply
        # zeros).  0.0 = exact full-spectrum matrices.  The truncated
        # forward/adjoint remain an exact transpose pair; the deviation from
        # the full conv is bounded by the dropped OTF magnitude (recorded
        # per channel in `conv_supports` after `host_tables`).
        self.conv_freq_rtol = float(conv_freq_rtol)
        # Input precision of the conv matmuls (core/precision.py): "highest"
        # = full f32 (shipped default, max rel 7.1e-6 vs FFT); "high" /
        # "default" let the backend round the operands (on the GPU, TF32
        # tensor cores).  Both directions use the same precision, so the
        # exact-transpose contract holds at any setting (and in float64 on
        # CPU the knob is a no-op).
        if conv_precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown conv_precision {conv_precision!r}")
        self.conv_precision = conv_precision
        # λ-rank factorization of the PSF stamps (fft.lowrank_stamp_factor):
        # per channel, SVD the [W, sx, sy] stamp window across λ and run the
        # whole post-conv pipeline (inverse DFT, composed gather/scatter,
        # wblur GEMM) on the Q = M·R rank-basis planes instead of the W
        # λ-planes, folding the static λ-mix into the wblur table
        # (fft.lmm_conv_rank).  PSFs vary smoothly with λ, so R ≈ 4–16 per
        # window while W ≈ 250–1400.  Components with σ_i/σ₁ ≤ conv_rank_rtol
        # are dropped; the deviation from the full conv is bounded by the
        # recorded per-channel tail (`conv_supports[c]["rank_tail"]`).  The
        # forward/transpose pair stays exact at any setting (the truncation
        # modifies the operator consistently in both directions — CG-safe).
        # 0.0 = off.  Takes effect only in the stamp-mode LMM matmul path;
        # channels where M·R ≥ W (no win) or where the composed gather is
        # unavailable keep the dense W-plane path.
        self.conv_rank_rtol = float(conv_rank_rtol)
        self.conv_supports = None
        # PSF-stamp mode: ship the compact per-λ PSF stamps [Nλ, sx, sy] and
        # evaluate the OTF in-graph (fft.otf_from_stamps) instead of hosting
        # / uploading the ~GB-scale precomputed OTF windows.  `sotf` may then
        # be None; only the window-local matmul conv supports this mode (the
        # FFT paths need the materialized transfer function).
        self.psf_stack = None if psf_stack is None else np.asarray(psf_stack)
        if sotf is None:
            if self.psf_stack is None:
                raise ValueError("need sotf or psf_stack")
            if not (self.window_local and conv_impl == "matmul"):
                raise ValueError(
                    "psf_stack-only mode requires window_local=True and "
                    "conv_impl='matmul' (FFT paths need a materialized sotf)"
                )
        self.sotf = None if sotf is None else np.asarray(sotf)
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.wavelength_axis = np.asarray(wavelength_axis, np.float64)
        self.step_degree = float(step_degree)
        self.templates = None if templates is None else np.asarray(templates)
        self.lmm = self.templates is not None
        self.instrs = [instr.pix(self.step_degree) for instr in instrs]

        # Per-channel SRF from detector pixel size vs step (arcsec).
        self.srfs = get_srf(
            [chan.det_pix_size for chan in instrs], self.step_degree * 3600
        )

        # Per-channel pointing lists: accept one CoordList for all channels or
        # a list of CoordList (the reference flagship signature).
        if isinstance(pointings, CoordList) or (
            len(pointings) and not isinstance(pointings[0], (list, CoordList))
        ):
            pointings = [CoordList(pointings) for _ in instrs]
        self.pointings = pointings

        if self.window_local and wblur_impl == "banded":
            # The tabled (window_local) pipelines source the wpsf from the
            # device-table pytree, which bypasses the banded gate in
            # Channel (it keys on `wpsf is self._wpsf_dev`) — the dense GEMM
            # path would silently run anyway.  Fall back loudly instead of
            # reporting a configuration that isn't executing.
            warnings.warn(
                "wblur_impl='banded' is not supported in window_local mode; "
                "falling back to the dense spectral blur",
                stacklevel=2,
            )
            wblur_impl = "dense"

        self.channels = [
            Channel(
                instr,
                self.alpha_axis,
                self.beta_axis,
                self.wavelength_axis,
                srf,
                CoordList(pointings[it]),
                step_degree,
                dtype=dtype,
                gridding=gridding,
                wblur_impl=wblur_impl,
                wblur_band_rtol=wblur_band_rtol,
            )
            for it, (srf, instr) in enumerate(zip(self.srfs, instrs))
        ]
        self.list_wslice = [chan.wslice for chan in self.channels]

        if self.lmm:
            ishape = (self.templates.shape[0], len(self.alpha_axis), len(self.beta_axis))
        else:
            ishape = (len(self.wavelength_axis), len(self.alpha_axis), len(self.beta_axis))

        self.instrs_oshape = [chan.oshape for chan in self.channels]
        self._idx = np.cumsum([0] + [int(np.prod(o)) for o in self.instrs_oshape])
        oshape = (int(self._idx[-1]),)

        self.cube_shape = (
            len(self.wavelength_axis),
            len(self.alpha_axis),
            len(self.beta_axis),
        )
        self.imshape = (len(self.alpha_axis), len(self.beta_axis))

        super().__init__(ishape=ishape, oshape=oshape, dtype=dtype)

        # host-side constants (jit embeds them; avoids D2H constant fetches)
        npctype = np.complex64 if dtype == jnp.float32 else np.complex128
        npdtype = np.float32 if dtype == jnp.float32 else np.float64
        self._sotf_dev = (
            None if self.sotf is None else np.asarray(self.sotf, npctype)
        )
        self._templates_dev = (
            np.asarray(self.templates, npdtype) if self.lmm else None
        )
        self._dev_tables = None
        if self.window_local:
            self._forward_jit = jax.jit(self._forward_fn_tabled)
            self._adjoint_fast_jit = jax.jit(self._adjoint_fn_tabled)
        else:
            self._forward_jit = jax.jit(self._forward_fn)
            self._adjoint_fast_jit = None
        self._fwadj_jit = None

    # ------------------------------------------------------------------
    # tables-as-arguments mode (window_local=True)
    # v2: banded wb blocks ship packed (cgrid_tz); v3: raw wpsf dropped from
    # rank-mode tables (wpsf_q is the only consumer table)
    _TABLE_CACHE_VERSION = 3

    def _table_cache_path(self):
        """Disk-cache path for the built host tables (stamp mode only).

        Building the flagship tables costs ~130 s of single-core host work
        (per-channel rank SVDs, DFT matrices, composed-plan rebases, host
        OTF/fold einsums) — the dominant term of a warm start after the
        compile cache removed recompiles.  The tables are a pure function
        of the model configuration, so they cache to disk keyed by a hash
        of every input.  SURFH_TABLE_CACHE=0 disables; a directory value
        overrides the default `.surfh_cache/tables` in the checkout."""
        import hashlib
        import os as _os

        from ..utils.cache import cache_dir

        loc = _os.environ.get("SURFH_TABLE_CACHE") or cache_dir("tables")
        if loc == "0" or self.psf_stack is None or self.conv_impl != "matmul":
            return None
        h = hashlib.sha1()
        h.update(str(self._TABLE_CACHE_VERSION).encode())
        for a in (self.wavelength_axis, self.templates, self.alpha_axis,
                  self.beta_axis):
            h.update(b"-" if a is None
                     else np.ascontiguousarray(a, np.float64).tobytes())
        h.update(np.ascontiguousarray(self.psf_stack, np.float32).tobytes())
        for instr, pts in zip(self.instrs, self.pointings):
            h.update(str((instr.name, instr.n_slit, instr.det_pix_size,
                          instr.fov.alpha_width, instr.fov.beta_width,
                          instr.fov.angle, len(instr.wavel_axis))).encode())
            h.update(np.asarray(
                [(p.alpha, p.beta) for p in pts], np.float64).tobytes())
        h.update(str((self.conv_impl, self.conv_freq_rtol,
                      self.conv_rank_rtol, self.conv_precision,
                      str(self.dtype), self.step_degree,
                      _os.environ.get("SURFH_HOST_MATERIALIZE", "1"),
                      # table-layout flags from the CHANNELS, not the env:
                      # host_tables builds lazily, so the env at build time
                      # can differ from the env the model was constructed
                      # under (a stale-cache hazard)
                      tuple((c.pointing_scan,
                             bool(getattr(c, "pointing_batch", False)),
                             bool(getattr(c, "pointing_cat", False)))
                            for c in self.channels),
                      # table LAYOUT knobs — a layered-era cache entry is
                      # shape-incompatible with the rows consumer
                      _os.environ.get("SURFH_COMPOSED_T_IMPL", "banded"),
                      _os.environ.get("SURFH_BANDED_TB", "256"),
                      _os.environ.get("SURFH_BANDED_SW", "128"),
                      _os.environ.get("SURFH_COMPOSED_T_LMAX", "16"),
                      _os.environ.get("SURFH_COMPOSED_GRIDDING", "1"),
                      )).encode())
        return _os.path.join(loc, f"tables_{h.hexdigest()[:16]}.pkl")

    def host_tables(self) -> dict:
        """All large model arrays as one host pytree (see `window_local`).

        Memoized in-memory: repeated calls (size accounting, upload, the
        numpy_ref oracle) must not re-run the ~160 s flagship build or
        re-load the pickle.  Callers must not mutate the
        returned tree.
        """
        import pickle

        if getattr(self, "_host_tables_mem", None) is not None:
            return self._host_tables_mem
        cache_path = self._table_cache_path()
        if cache_path and os.path.exists(cache_path):
            with open(cache_path, "rb") as fh:
                out, self.conv_supports = pickle.load(fh)
            self._host_tables_mem = out
            return out
        out = self._build_host_tables()
        if cache_path:
            try:
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                tmp = cache_path + ".tmp"
                with open(tmp, "wb") as fh:
                    pickle.dump((out, self.conv_supports), fh, protocol=4)
                os.replace(tmp, cache_path)
            except OSError:
                pass  # best-effort cache
        self._host_tables_mem = out
        return out

    def _build_host_tables(self) -> dict:
        # Two layout choices:
        # * sotf ships as a stacked (real, imag) float pair, and
        #   lax.complex rebuilds it on device; every table upload is then a
        #   real float array.
        # * the OTF is pre-sliced per channel λ-window on the HOST rather
        #   than uploaded once globally and lax.slice'd in-jit: at flagship
        #   scale the global [3879,501,251,2] array is 3.73 GB and XLA kept
        #   TWO full relayout copies of it alive across the solver loop
        #   (7.5 GB of HLO temp).  The windows overlap (Σ W ≈ 1.27× the
        #   global axis) so per-channel slices cost ~27% more argument
        #   memory but eliminate both whole-array copies.
        chans = []
        matmul = self.conv_impl == "matmul"
        truncate = matmul and self.conv_freq_rtol > 0.0
        stamps = matmul and self.psf_stack is not None
        npdtype = np.float32 if self.dtype == jnp.float32 else np.float64
        supports = []
        na_g, nb_g = self.imshape
        for chan in self.channels:
            t = dict(chan.host_tables())
            if "cgrid_t" in t and chan._composed_t_impl == "banded":
                # The banded transpose's dense [P, nb, tb, sw] weight
                # blocks are ~5 % nonzero and dominate the table upload
                # (GB-scale at flagship).  Ship the packed nonzeros instead;
                # `materialize_otf` rebuilds the dense blocks on device once
                # (bilinear.unpack_banded_weights).
                linv, idx, wbk, osrc, ow, odst = t.pop("cgrid_t")
                nzi, nzv = bilinear.pack_banded_weights(wbk)
                t["cgrid_tz"] = (linv, idx, nzi, nzv, osrc, ow, odst)
            if "cgrid_mt" in t:
                # same packing for the pointing-summed banded transpose's
                # [nb, tb, P·sw] concatenated weight blocks (batch axis nb)
                linv, idx, wbcat, osrc, wsel, odst = t.pop("cgrid_mt")
                nzi, nzv = bilinear.pack_banded_weights(wbcat)
                t["cgrid_mtz"] = (linv, idx, nzi, nzv, osrc, wsel, odst)
            if "cgrid_ct" in t:
                # same packing for the pointing-CONCATENATED banded
                # transpose (its weight blocks are the per-pointing stack)
                linv, idx, wbk, osrc, ow, odst = t.pop("cgrid_ct")
                nzi, nzv = bilinear.pack_banded_weights(wbk)
                t["cgrid_ctz"] = (linv, idx, nzi, nzv, osrc, ow, odst)
            psf_w = (
                np.asarray(
                    self.psf_stack[chan.wslice.start : chan.wslice.stop], npdtype
                )
                if stamps
                else None
            )
            s = (
                None
                if self._sotf_dev is None
                else self._sotf_dev[chan.wslice.start : chan.wslice.stop]
            )
            if matmul:
                # Per-channel DFT matrices: (a) frequency support of the OTF
                # window — the short-λ bands keep the most bins (widest OTF),
                # the long-λ bands the fewest; (b) spatial output restricted
                # to the channel's FOV bbox (the gridding gather never reads
                # outside it — an exact restriction, see dft_matmul_tables).
                # The forward gather plans are rebased to bbox-local indices
                # (out-of-bbox entries carry weight 0 and clip to the edge).
                ka_max, kb_keep, dropped = (None, None, 0.0)
                if truncate:
                    if stamps:
                        ka_max, kb_keep, dropped = fft.otf_support_from_psf(
                            psf_w, self.imshape, self.conv_freq_rtol
                        )
                    else:
                        ka_max, kb_keep, dropped = fft.otf_freq_support(
                            s, self.conv_freq_rtol
                        )
                    sel_a = fft.freq_sel_alpha(na_g, ka_max)
                    if s is not None:
                        s = np.ascontiguousarray(s[:, sel_a, :kb_keep])
                a0, b0, ha, wb = chan._tbbox
                t["dftm"] = fft.dft_matmul_tables(
                    self.imshape,
                    npdtype,
                    ka_max=ka_max,
                    kb_keep=kb_keep,
                    bbox=chan._tbbox,
                )
                if "plan_idx" in t:  # staged-pipeline tables (composed off)
                    idx = np.asarray(t["plan_idx"])
                    rows = np.clip(idx // nb_g - a0, 0, ha - 1)
                    cols = np.clip(idx % nb_g - b0, 0, wb - 1)
                    t["plan_idx"] = (rows * wb + cols).astype(idx.dtype)
                supports.append(
                    dict(
                        ka_max=ka_max,
                        kb_keep=kb_keep,
                        dropped_rel=dropped,
                        bbox=chan._tbbox,
                        keep_frac=(
                            1.0
                            if not truncate
                            else len(sel_a)
                            * kb_keep
                            / (na_g * (nb_g // 2 + 1))
                        ),
                    )
                )
            if stamps:
                # PSF-stamp mode: ship [W, sx, sy] stamps + the stamp-DFT
                # matrices; the OTF window is evaluated in-graph
                # (fft.otf_from_stamps) — ~100× less argument memory/upload
                # than the materialized OTF window.
                rank_on = (
                    self.conv_rank_rtol > 0.0
                    and self.lmm
                    # rank planes ride the composed gather (either layout)
                    and ("cgrid" in t or "cgrid_b" in t)
                )
                if rank_on:
                    cu, v_psf, tail = fft.lowrank_stamp_factor(
                        psf_w, self.conv_rank_rtol
                    )
                    n_tpl = self.templates.shape[0]
                    # no win unless the Q = M·R basis is decisively smaller
                    # than the W λ-planes it replaces
                    rank_on = n_tpl * cu.shape[1] < psf_w.shape[0] // 2
                if rank_on:
                    t["cu"] = cu
                    supports[-1]["rank"] = int(cu.shape[1])
                    supports[-1]["rank_tail"] = tail
                    if os.environ.get("SURFH_HOST_MATERIALIZE", "1") != "0":
                        # rank mode: materialize the R≈13-plane rank-basis
                        # OTF and the λ-mix-folded wblur table ON THE HOST
                        # (float64 einsums over a tiny basis).  This removes
                        # all 24 per-channel materialization jits (and their
                        # compiles) from the startup path, at +~13 MB/channel
                        # of upload.  Both consumer programs share the one
                        # host value, so the exact-transpose contract is
                        # pinned even harder than device materialization.
                        st = fft.psf_stamp_tables(
                            self.imshape, v_psf.shape[-2:], np.float64,
                            ka_max=ka_max, kb_keep=kb_keep,
                        )
                        sa = st["sa_re"] + 1j * st["sa_im"]
                        sb = st["sb_re"] + 1j * st["sb_im"]
                        z = np.einsum("wxy,cx->wcy", v_psf.astype(np.float64), sa)
                        otf = np.einsum("wcy,yk->wck", z, sb)
                        t["sotf_ri"] = np.ascontiguousarray(
                            np.stack([otf.real, otf.imag]), npdtype
                        )
                        tpl_w64 = self.templates[:, chan.wslice].astype(np.float64)
                        cmat = np.einsum(
                            "mw,wr->wmr", tpl_w64, cu.astype(np.float64)
                        ).reshape(tpl_w64.shape[1], -1)
                        t["wpsf_q"] = np.ascontiguousarray(
                            np.einsum("kwb,wq->kqb", t["wpsf"].astype(np.float64), cmat),
                            npdtype,
                        )
                        # the rank-basis programs contract ONLY with the
                        # folded wpsf_q — the raw [K, W, B] wpsf is the
                        # single largest remaining upload (259 MB of the
                        # flagship's 516 MB) and is dead weight here
                        del t["wpsf"]
                    else:
                        t["psf"] = v_psf
                else:
                    t["psf"] = psf_w
                if "psf" in t:
                    t["stamp"] = fft.psf_stamp_tables(
                        self.imshape,
                        t["psf"].shape[-2:],
                        npdtype,
                        ka_max=ka_max,
                        kb_keep=kb_keep,
                    )
            else:
                # axis-0 (planar) stack: the row-major argument layout then
                # matches the complex-unpack consumer's preferred layout, so
                # XLA binds the argument directly instead of holding a full
                # relayout copy per channel in HLO temp (measured: last-axis
                # stacking cost ~4.7 GB of copies at flagship scale -> OOM).
                t["sotf_ri"] = np.stack([s.real, s.imag], axis=0)
            chans.append(t)
        self.conv_supports = supports if matmul else None
        out = {
            "tpl": self._templates_dev,
            "chan": tuple(chans),
        }
        return out

    def materialize_otf(self, tables, out_sharding=None):
        """Evaluate per-channel OTF windows from PSF stamps ON DEVICE, once.

        Stamp-mode host tables ship [W, sx, sy] PSF stamps (~100× smaller
        than the OTF windows); this turns them into resident `sotf_ri` device arrays
        via :func:`fft.otf_from_stamps`.  Evaluating once (instead of
        in-graph per application) pins the OTF bit-exactly across the
        forward/adjoint programs, keeping the exact-transpose contract at
        machine precision (in-graph evaluation re-associates differently
        per program — measured 1e-10-level dot-test drift)."""
        chans = []
        changed = False
        jit_kwargs = {"out_shardings": out_sharding} if out_sharding else {}
        for c, t in enumerate(tables["chan"]):
            if "cgrid_tz" in t:
                # rebuild the dense banded weight blocks from their packed
                # nonzeros (shipped compressed — see _build_host_tables);
                # one scatter-add per model, bit-exact, shared by every
                # consumer program
                t = dict(t)
                linv, idx, nzi, nzv, osrc, ow, odst = t.pop("cgrid_tz")
                bshape = self.channels[c]._composed_t_stack[2].shape[1:]
                unpack = jax.jit(
                    lambda i, v, s=bshape: bilinear.unpack_banded_weights(
                        i, v, s
                    ),
                    **jit_kwargs,
                )
                t["cgrid_t"] = (linv, idx, unpack(nzi, nzv), osrc, ow, odst)
                changed = True
            if "cgrid_mtz" in t:
                t = dict(t)
                linv, idx, nzi, nzv, osrc, wsel, odst = t.pop("cgrid_mtz")
                bshape = self.channels[c]._composed_t_stack_mp[2].shape[1:]
                unpack = jax.jit(
                    lambda i, v, s=bshape: bilinear.unpack_banded_weights(
                        i, v, s
                    ),
                    **jit_kwargs,
                )
                t["cgrid_mt"] = (linv, idx, unpack(nzi, nzv),
                                 osrc, wsel, odst)
                changed = True
            if "cgrid_ctz" in t:
                t = dict(t)
                linv, idx, nzi, nzv, osrc, ow, odst = t.pop("cgrid_ctz")
                bshape = self.channels[c]._composed_t_cat[2].shape[1:]
                unpack = jax.jit(
                    lambda i, v, s=bshape: bilinear.unpack_banded_weights(
                        i, v, s
                    ),
                    **jit_kwargs,
                )
                t["cgrid_ct"] = (linv, idx, unpack(nzi, nzv), osrc, ow, odst)
                changed = True
            if "psf" in t:
                f = jax.jit(
                    lambda p, st: jnp.stack(fft.otf_from_stamps(p, st)),
                    **jit_kwargs,
                )
                t = dict(t)
                t["sotf_ri"] = f(t["psf"], t["stamp"])
                del t["psf"], t["stamp"]
                changed = True
            if "cu" in t and "wpsf_q" not in t:
                # rank mode: fold the static λ-mix (templates × rank
                # coefficients) into the wblur table ONCE — materializing
                # (rather than folding in-graph per program) pins the table
                # bit-exactly across the forward/adjoint compiles, keeping
                # the exact-transpose contract at machine precision (same
                # rationale as the OTF materialization above).
                wsl = self.channels[c].wslice
                t = dict(t)

                def fold(wpsf, tpl, cu, lo=wsl.start, hi=wsl.stop):
                    tpl_w = jax.lax.slice_in_dim(tpl, lo, hi, axis=1)
                    cmat = jnp.einsum(
                        "mw,wr->wmr", tpl_w, cu, precision="highest"
                    )
                    cmat = cmat.reshape(cmat.shape[0], -1)
                    return jnp.einsum(
                        "kwb,wq->kqb", wpsf, cmat, precision="highest"
                    )

                t["wpsf_q"] = jax.jit(fold, **jit_kwargs)(
                    t["wpsf"], tables["tpl"], t["cu"]
                )
                changed = True
            chans.append(t)
        if not changed:
            return tables
        out = dict(tables)
        out["chan"] = tuple(chans)
        return out

    def device_tables(self):
        """Device-resident tables, uploaded once and cached."""
        if self._dev_tables is None:
            self._dev_tables = self.materialize_otf(
                jax.device_put(self.host_tables())
            )
        return self._dev_tables

    def solver_args(self) -> tuple:
        """Extra trailing args solvers must thread through to the pure fns."""
        return (self.device_tables(),) if self.window_local else ()

    @staticmethod
    def _wpsf_q(t, tpl_w):
        """Rank-folded wblur table [K, Q, B] (see `conv_rank_rtol`): the
        materialized copy when present (`materialize_otf` pins it bit-exactly
        across the forward/adjoint programs), else folded in-graph — the fold
        is cheap (K·W·B·Q FLOPs) and identical in both directions."""
        if "wpsf_q" in t:
            return t["wpsf_q"]
        cmat = jnp.einsum("mw,wr->wmr", tpl_w, t["cu"], precision="highest")
        cmat = cmat.reshape(cmat.shape[0], -1)
        return jnp.einsum("kwb,wq->kqb", t["wpsf"], cmat, precision="highest")

    def _channel_fwd_tabled(self, x, c: int, tables):
        """One channel's T·C·(S·L·R·Sig) over its λ-window, tables as args."""
        chan = self.channels[c]
        t = tables["chan"][c]
        wsl = chan.wslice
        if "psf" in t:
            o_re, o_im = fft.otf_from_stamps(t["psf"], t["stamp"])
        else:
            sotf_ri = t["sotf_ri"]
            o_re, o_im = sotf_ri[0], sotf_ri[1]
        if self.lmm:
            tpl_w = jax.lax.slice_in_dim(tables["tpl"], wsl.start, wsl.stop, axis=1)
            if self.conv_impl == "matmul" and t.get("cu") is not None:
                # rank-basis pipeline: conv onto the Q = M·R basis planes,
                # gather/slit-window them, contract with the λ-mix-folded
                # wblur table — nothing downstream scales with W
                yq = fft.lmm_conv_rank(
                    x, o_re, o_im, t["dftm"], precision=self.conv_precision
                )
                return chan._forward_windowed_impl(
                    yq, self._wpsf_q(t, tpl_w), "dense", tables=t, bbox_in=True
                )
            if self.conv_impl == "matmul":
                # fused T·C: forward-DFT the M template maps, mix + OTF in
                # Fourier, inverse per λ-plane onto the FOV bbox only (never
                # materializes T·x nor the out-of-footprint 90% of the grid)
                blurred = fft.lmm_conv_otf_matmul(
                    x, tpl_w, o_re, o_im, t["dftm"],
                    precision=self.conv_precision,
                )
                return chan._forward_windowed_impl(
                    blurred, t["wpsf"], "dense", tables=t, bbox_in=True
                )
            cube_w = lmm.lmm_maps2cube(x, tpl_w)
        else:
            cube_w = jax.lax.slice_in_dim(x, wsl.start, wsl.stop, axis=0)
        if self.conv_impl == "matmul":
            blurred = fft.conv_otf_matmul(
                cube_w, o_re, o_im, t["dftm"], precision=self.conv_precision
            )
        else:
            sotf_w = jax.lax.complex(o_re, o_im)
            blurred = fft.idft(fft.dft(cube_w) * sotf_w, self.imshape)
        return chan._forward_windowed_impl(
            blurred, t["wpsf"], "dense", tables=t,
            bbox_in=self.conv_impl == "matmul",
        )

    def _channel_adj_tabled(self, yc, c: int, tables):
        """Exact transpose of :meth:`_channel_fwd_tabled` (maps/cube-window)."""
        chan = self.channels[c]
        t = tables["chan"][c]
        wsl = chan.wslice
        if "psf" in t:
            o_re, o_im = fft.otf_from_stamps(t["psf"], t["stamp"])
        else:
            sotf_ri = t["sotf_ri"]
            o_re, o_im = sotf_ri[0], sotf_ri[1]
        if self.conv_impl == "matmul" and self.lmm and t.get("cu") is not None:
            # rank-basis twin: wblur_t with the folded table, composed
            # scatter of Q planes, then the exact transpose of the
            # rank-basis conv back to the M template maps
            tpl_w = jax.lax.slice_in_dim(
                tables["tpl"], wsl.start, wsl.stop, axis=1
            )
            n_tpl = int(tables["tpl"].shape[0])
            q = n_tpl * int(t["cu"].shape[1])
            patch_q = chan._adjoint_windowed_fast_impl(
                yc, q, self._wpsf_q(t, tpl_w), tables=t, bbox_out=True
            )
            return fft.lmm_conv_rank_t(
                patch_q, o_re, o_im, t["dftm"], n_tpl,
                precision=self.conv_precision,
            )
        cube_w = chan._adjoint_windowed_fast_impl(
            yc, chan.n_wslice, t["wpsf"], tables=t,
            bbox_out=self.conv_impl == "matmul",
        )
        if self.conv_impl == "matmul":
            if self.lmm:
                # fused Tᵗ·Cᵗ twin: inverse-DFT stages run on M template
                # planes (exact transpose of the fused forward); input is the
                # FOV-bbox patch straight from the gridding transpose
                tpl_w = jax.lax.slice_in_dim(
                    tables["tpl"], wsl.start, wsl.stop, axis=1
                )
                return fft.lmm_conv_otf_matmul_t(
                    cube_w, tpl_w, o_re, o_im, t["dftm"],
                    precision=self.conv_precision,
                )
            # exact transpose of the forward's matmul conv (NOT conj-multiply)
            blurred_t = fft.conv_otf_matmul_t(
                cube_w, o_re, o_im, t["dftm"], precision=self.conv_precision
            )
        else:
            sotf_w = jax.lax.complex(o_re, o_im)
            blurred_t = fft.idft(fft.dft(cube_w) * jnp.conj(sotf_w), self.imshape)
        if self.lmm:
            tpl_w = jax.lax.slice_in_dim(tables["tpl"], wsl.start, wsl.stop, axis=1)
            return lmm.lmm_cube2maps(blurred_t, tpl_w)
        return blurred_t

    def _forward_fn_tabled(self, x, tables):
        outs = []
        for c in range(len(self.channels)):
            outs.append(self._channel_fwd_tabled(x, c, tables).ravel())
        return jnp.concatenate(outs)

    def _adjoint_fn_tabled(self, y, tables):
        y = jnp.asarray(y, self.dtype).reshape(self.oshape)
        if self.lmm:
            acc = jnp.zeros(self.ishape, self.dtype)
        else:
            acc = jnp.zeros(self.cube_shape, self.dtype)
        for c, chan in enumerate(self.channels):
            yc = y[int(self._idx[c]) : int(self._idx[c + 1])].reshape(chan.oshape)
            contrib = self._channel_adj_tabled(yc, c, tables)
            if self.lmm:
                acc = acc + contrib
            else:
                acc = acc.at[chan.wslice.start : chan.wslice.stop].add(contrib)
        return acc

    def _normal_fn_tabled(self, x, tables):
        """Fused HᵗH x — per-channel fwd∘adj without materializing the flat y."""
        acc = jnp.zeros(self.ishape, self.dtype)
        for c in range(len(self.channels)):
            yc = self._channel_fwd_tabled(x, c, tables)
            contrib = self._channel_adj_tabled(yc, c, tables)
            if self.lmm:
                acc = acc + contrib
            else:
                chan = self.channels[c]
                acc = acc.at[chan.wslice.start : chan.wslice.stop].add(contrib)
        return acc

    # ------------------------------------------------------------------
    def _forward_fn(self, x):
        if self._sotf_dev is None:
            raise RuntimeError(
                "psf_stack-only model: the non-tabled FFT paths need a "
                "materialized sotf (construct with sotf=... for these)"
            )
        if self.lmm:
            cube = lmm.lmm_maps2cube(x, self._templates_dev)
        else:
            cube = x
        blurred = fft.idft(fft.dft(cube) * self._sotf_dev, self.imshape)
        outs = []
        for chan in self.channels:
            xw = jax.lax.slice_in_dim(
                blurred, chan.wslice.start, chan.wslice.stop, axis=0
            )
            outs.append(chan._forward_windowed(xw, chan._wpsf_dev).ravel())
        return jnp.concatenate(outs)

    def forward(self, x):
        x = jnp.asarray(x, self.dtype).reshape(self.ishape)
        if self.window_local:
            return self._forward_jit(x, self.device_tables())
        return self._forward_jit(x)

    def forward_fn(self, x, *op_args):
        """Pure function (for jit composition in solvers).

        In `window_local` mode the device-table pytree must be threaded
        through as the trailing argument (see :meth:`solver_args`)."""
        if self.window_local:
            return self._forward_fn_tabled(x, *op_args)
        return self._forward_fn(x)

    # ------------------------------------------------------------------
    def adjoint_fn(self, y, *op_args):
        if self.window_local:
            return self._adjoint_fn_tabled(y, *op_args)
        return self._adjoint_fn_const(y)

    def adjoint_fn_const(self, y):
        return self._adjoint_fn_const(y)

    def _adjoint_fn_const(self, y):
        """Hand-written exact transpose of :meth:`_forward_fn` (pure fn).
        Unavailable in psf_stack-only mode (see :meth:`_forward_fn`).

        Mathematically identical to the derived `linear_transpose` (the
        LinOp default, kept as :meth:`adjoint_auto`), but with the gridding
        transpose as a presorted segment-sum and the spectral-blur transpose
        as one GEMM per pointing.
        """
        if self._sotf_dev is None:
            raise RuntimeError(
                "psf_stack-only model: the non-tabled FFT paths need a "
                "materialized sotf (construct with sotf=... for these)"
            )
        # Coerce to the model dtype up front: callers (criterion setup paths)
        # may pass float64 NumPy data under x64, and a float64 update into the
        # float32 cube scatter is a FutureWarning → hard error in future JAX.
        y = jnp.asarray(y, self.dtype).reshape(self.oshape)
        cube = jnp.zeros(self.cube_shape, self.dtype)
        for c, chan in enumerate(self.channels):
            block = y[int(self._idx[c]) : int(self._idx[c + 1])].reshape(chan.oshape)
            cube_w = chan._adjoint_windowed_fast(block)
            # static λ-window scatter-add (overlapping windows accumulate);
            # the channel adjoint may promote to float64 under x64 (its static
            # wpsf tables are host float64) — match the cube dtype so the
            # scatter never needs an unsafe implicit downcast.
            cube = cube.at[chan.wslice.start : chan.wslice.stop].add(
                cube_w.astype(cube.dtype)
            )
        blurred_t = fft.idft(fft.dft(cube) * jnp.conj(self._sotf_dev), self.imshape)
        if self.lmm:
            return lmm.lmm_cube2maps(blurred_t, self._templates_dev)
        return blurred_t

    def adjoint(self, y):
        """Exact adjoint (hand-optimized path; see :meth:`adjoint_fn`)."""
        y = jnp.asarray(y, self.dtype).reshape(self.oshape)
        if self.window_local:
            return self._adjoint_fast_jit(y, self.device_tables())
        if self._adjoint_fast_jit is None:
            self._adjoint_fast_jit = jax.jit(self._adjoint_fn_const)
        return self._adjoint_fast_jit(y)

    def adjoint_auto(self, y):
        """Derived `linear_transpose` adjoint (reference for tests).

        Transposes the dense-wblur forward — identical math to the banded
        spelling."""
        if self._transpose_fn is None:

            def dense_fwd(x):
                if self.lmm:
                    cube = lmm.lmm_maps2cube(x, self._templates_dev)
                else:
                    cube = x
                blurred = fft.idft(fft.dft(cube) * self._sotf_dev, self.imshape)
                outs = []
                for chan in self.channels:
                    xw = jax.lax.slice_in_dim(
                        blurred, chan.wslice.start, chan.wslice.stop, axis=0
                    )
                    outs.append(
                        chan._forward_windowed_dense(xw, chan._wpsf_dev).ravel()
                    )
                return jnp.concatenate(outs)

            from ..core.linop import build_transpose

            primal = jax.ShapeDtypeStruct(self.ishape, self.dtype)
            transpose = build_transpose(dense_fwd, primal)
            self._transpose_fn = jax.jit(
                lambda y: transpose(jnp.asarray(y, self.dtype).reshape(self.oshape))[0]
            )
        return self._transpose_fn(y)

    # ------------------------------------------------------------------
    def mapsToCube(self, maps):
        return lmm.lmm_maps2cube(jnp.asarray(maps, self.dtype), self._templates_dev)

    def cubeTomaps(self, cube):
        return lmm.lmm_cube2maps(jnp.asarray(cube, self.dtype), self._templates_dev)

    def split(self, data):
        """Split the flat data vector into per-channel 4-D blocks."""
        flat = np.asarray(data).ravel()
        return [
            flat[self._idx[i] : self._idx[i + 1]].reshape(self.instrs_oshape[i])
            for i in range(len(self.channels))
        ]

    def concat(self, blocks) -> np.ndarray:
        """Inverse of :meth:`split`."""
        return np.concatenate([np.asarray(b).ravel() for b in blocks])

    # ------------------------------------------------------------------
    def real_data_janskySR_to_jansky(self, data):
        """Flux normalization of raw real data (reference :225-239): scale each
        slit by the summed β weights of its first row × the channel SRF."""
        data = np.array(data)
        for ch_idx, chan in enumerate(self.channels):
            block = data[self._idx[ch_idx] : self._idx[ch_idx + 1]].reshape(
                self.instrs_oshape[ch_idx]
            )
            for slit in range(self.instrs_oshape[ch_idx][1]):
                slices = chan.slicer.get_slit_slices(slit)
                weights = chan.slicer.get_slit_weights(slit, slices)
                block[:, slit] = block[:, slit] * np.sum(weights[0, 0, :]) * self.srfs[ch_idx]
            data[self._idx[ch_idx] : self._idx[ch_idx + 1]] = block.ravel()
        return data

    def plot_slice(self, all_data, n_chan: int, nslice: int):
        """Re-project one detector λ-slice of a channel onto the sky
        (reference spectroModel.py:242-286): β-duplicate each slit row,
        α-upsample, conj SRF-OTF, reverse-grid, and co-add over pointings.
        Returns (weighted_mean, global_img)."""
        from ..core import numpy_ref

        chan = self.channels[n_chan]
        global_img = np.zeros(self.imshape)
        cum_grid = np.zeros((len(self.pointings[n_chan]),) + self.imshape)

        all_data = np.asarray(all_data).ravel()
        chan_data = all_data[self._idx[n_chan] : self._idx[n_chan + 1]]
        data = chan_data.reshape(chan.oshape)[:, :, nslice, :]

        nla, nlb = chan.local_im_shape
        sb = chan.slicer.npix_slit_beta_width
        for p_idx in range(len(chan.pointings)):
            local_img = np.zeros((nla, nlb))
            for slit_idx in range(chan.instr.n_slit):
                over = (
                    np.repeat(data[p_idx, slit_idx][:, np.newaxis], sb, axis=1)
                    / (sb * chan.srf)
                )
                sliced = np.zeros((1,) + chan.slicer.get_slit_shape()[1:])
                sliced[0, : data.shape[2] * chan.srf : chan.srf, :] = over
                local_img += chan.slicer.slicing_t(
                    sliced, slit_idx, (1, nla, nlb)
                )[0]
            sum_t = np.fft.irfftn(
                np.fft.rfftn(local_img, axes=(-2, -1), norm="ortho")
                * (chan._otf_sr[0].conj() * chan.decalf.conj()),
                s=(nla, nlb),
                axes=(-2, -1),
                norm="ortho",
            )
            degridded = numpy_ref.apply_plan(
                chan.plans_rev[p_idx], sum_t[np.newaxis]
            ).reshape(self.imshape)
            global_img += degridded
            cum_grid[p_idx] = degridded
        valid = np.sum(cum_grid > 100, axis=0)
        total = np.sum(cum_grid, axis=0)
        weighted_mean = np.divide(total, valid, where=valid != 0)
        return weighted_mean, global_img

    def _mask_group_leads(self):
        """First band of each MIRI channel (the reference's `ch = i*3` over
        its fixed 12-band A/B/C-ordered list, spectroModel.py:296-297),
        generalized: group by the channel digit in the band name when names
        look like MIRI bands, else fall back to consecutive triples — so
        non-multiple-of-3 band lists produce sensible groups."""
        leads, seen = [], set()
        for i, chan in enumerate(self.channels):
            name = str(getattr(chan.instr, "name", "") or "")
            key = name[0] if name[:1].isdigit() else f"g{i // 3}"
            if key not in seen:
                seen.add(key)
                leads.append(i)
        return leads

    def make_mask(self, all_data, threshold: float = 50.0, nslice: int = 50):
        """One binary spatial mask per channel group (reference :289-338):
        re-project one detector λ-slice of the first band of each channel
        onto the sky — the `plot_slice` re-projection, NO spectral blur —
        and threshold the co-added image."""
        masks = []
        for ch in self._mask_group_leads():
            _, global_img = self.plot_slice(all_data, ch, nslice)
            masks.append(global_img > threshold)
        return masks
