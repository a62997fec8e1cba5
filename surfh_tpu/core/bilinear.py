"""Bilinear regridding (the S operator) as precomputed gather / scatter-add.

The reference performs per-λ bilinear resampling between the global sky grid
and each pointing's rotated local FOV grid with a Cython binary-search
interpolator (`surfh/ToolsDir/cythons_files.pyx:20-193`, driver
`surfh/ToolsDir/cython_2D_interpolation.py`).  Grids are static per model
instance, so on the accelerator the whole interpolation collapses to:

* construction time (host, float64): compute the 4 corner indices and weights
  of every target point once;
* trace time: a 4-term flattened gather, batched over all λ planes
  (`cube[:, flat_idx]`), whose linear transpose is automatically the exact
  4-point scatter-add — no hand-written adjoint needed.

The reference's `interpn_local2cube` "adjoint" is itself a bilinear
interpolation in the reverse direction (`surfh/ToolsDir/cython_utils.py:33-58`)
— an *approximate* transpose under rotation.  :func:`bilinear_plan` +
gather/transpose gives the exact adjoint; the reverse-interp behaviour remains
available for output-parity checks by building a plan in the other direction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from .precision import gemm_precision
import numpy as np


def take_ib(a, indices, axis):
    """`jnp.take` for host-built plan indices, which are in-bounds by
    construction (padding entries point at valid zero rows/slots).

    `jnp.take`'s default mode="fill" appends a compare+select pass over the
    ENTIRE gathered array to blank out-of-bounds rows — measured at 7.6 of
    the flagship app's 55 device-ms across the composed gathers/transposes
    (round-4 trace, PERF.md).  mode="clip" clamps the indices instead (a
    scalar op fused into the gather) and is bit-identical for in-bounds
    indices.

    The in-bounds invariant is enforced here at trace time whenever the
    indices are a host plan table (np.ndarray): a future builder that emits
    a -1/size sentinel would silently gather a clamped real row otherwise."""
    if isinstance(indices, np.ndarray) and indices.size:
        n = a.shape[axis]
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= n:
            raise ValueError(
                f"take_ib: plan indices out of bounds [{lo}, {hi}] for axis "
                f"size {n}; mode='clip' would silently clamp them"
            )
    return jnp.take(a, indices, axis=axis, mode="clip")


@dataclass(frozen=True)
class BilinearPlan:
    """Static gather plan: 4 corner flat indices + weights for P target points.

    idx:  int32 [4, P] flat indices into the source grid raveled (Na*Nb).
    w:    float [4, P] corner weights (already zeroed for out-of-bounds points
          when ``fill_value=0`` semantics were requested).
    shape: source grid shape (Na, Nb).
    npoints: P.
    """

    idx: np.ndarray
    w: np.ndarray
    shape: Tuple[int, int]

    @property
    def npoints(self) -> int:
        return self.idx.shape[1]


def _find_interval(grid: np.ndarray, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Clamped interval search: i such that grid[i] <= v < grid[i+1].

    Matches `find_interval_ascending(..., extrapolate=1)`
    (/root/reference/surfh/ToolsDir/cythons_files.pyx:20-103): indices clamp to
    [0, n-2] so outside values extrapolate linearly.
    """
    n = grid.shape[0]
    i = np.searchsorted(grid, values, side="right") - 1
    i = np.clip(i, 0, n - 2)
    t = (values - grid[i]) / (grid[i + 1] - grid[i])
    return i.astype(np.int64), t


def bilinear_plan(
    alpha_axis: np.ndarray,
    beta_axis: np.ndarray,
    points: np.ndarray,
    fill_out_of_bounds: bool = False,
) -> BilinearPlan:
    """Build the static plan interpolating grid values at ``points``.

    Parameters
    ----------
    alpha_axis, beta_axis:
        Ascending source-grid axes (Na,), (Nb,).
    points:
        Target coordinates [P, 2] as (alpha, beta) pairs.
    fill_out_of_bounds:
        If True, points outside the source grid produce 0 (the
        ``bounds_error=False, fill_value=0`` mode of the reference's
        local→cube direction).  If False, outside points linearly extrapolate
        (the cube→local direction; model construction guarantees in-bounds).
    """
    alpha_axis = np.asarray(alpha_axis, np.float64)
    beta_axis = np.asarray(beta_axis, np.float64)
    pa = np.asarray(points[:, 0], np.float64)
    pb = np.asarray(points[:, 1], np.float64)

    ia, ta = _find_interval(alpha_axis, pa)
    ib, tb = _find_interval(beta_axis, pb)

    nb = beta_axis.shape[0]
    base = ia * nb + ib
    idx = np.stack([base, base + 1, base + nb, base + nb + 1])
    w = np.stack([(1 - ta) * (1 - tb), (1 - ta) * tb, ta * (1 - tb), ta * tb])

    if fill_out_of_bounds:
        oob = (
            (pa < alpha_axis[0])
            | (pa > alpha_axis[-1])
            | (pb < beta_axis[0])
            | (pb > beta_axis[-1])
        )
        w = np.where(oob[np.newaxis, :], 0.0, w)

    return BilinearPlan(idx.astype(np.int32), w, (alpha_axis.shape[0], nb))


def apply_plan(plan_idx, plan_w, cube):
    """Gather-interpolate every λ plane of ``cube`` at the plan's points.

    cube: [..., Na, Nb] → out [..., P].  Jit-friendly; the transpose of this
    function (via `jax.linear_transpose`) is the exact scatter-add adjoint.
    """
    flat = cube.reshape(cube.shape[:-2] + (-1,))
    out = jnp.zeros(cube.shape[:-2] + (plan_idx.shape[1],), dtype=cube.dtype)
    for c in range(plan_idx.shape[0]):
        out = out + plan_w[c] * take_ib(flat, plan_idx[c], -1)
    return out


def scatter_plan(plan_idx, plan_w, values, grid_shape: Tuple[int, int]):
    """Explicit exact adjoint of :func:`apply_plan` (4-point scatter-add).

    values: [..., P] → out [..., Na, Nb].
    """
    na, nb = grid_shape
    flat = jnp.zeros(values.shape[:-1] + (na * nb,), dtype=values.dtype)
    for c in range(plan_idx.shape[0]):
        flat = flat.at[..., plan_idx[c]].add(plan_w[c] * values)
    return flat.reshape(values.shape[:-1] + (na, nb))


@dataclass(frozen=True)
class TransposePlan:
    """Transpose-as-gather form of a gather plan's adjoint.

    The exact adjoint of :func:`apply_plan` is a 4-point scatter-add (a
    generic scatter / segment reduction).  But each *grid*
    pixel receives contributions from a small bounded set of target points
    (≈ the local/global grid density ratio × 4 corners), so the transpose is
    itself a padded gather: per grid pixel, up to C (source index, weight)
    pairs, zero-padded.  Applying it is the same vectorized weighted-gather
    shape as the forward — no scatter anywhere in the pipeline.
    """

    idx: np.ndarray  # int32 [C, Na·Nb] indices into the P target points
    w: np.ndarray  # float [C, Na·Nb] weights (0 padding)
    shape: Tuple[int, int]


def transpose_plan(plan: BilinearPlan) -> TransposePlan:
    """Build the padded gather-form transpose of a plan (host, once)."""
    ncorner, P = plan.idx.shape
    N = plan.shape[0] * plan.shape[1]
    src = np.tile(np.arange(P, dtype=np.int64), ncorner)
    dst = plan.idx.reshape(-1).astype(np.int64)
    w = plan.w.reshape(-1)
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    counts = np.bincount(dst, minlength=N)
    C = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    idx_arr = np.zeros((C, N), np.int32)
    w_arr = np.zeros((C, N), plan.w.dtype)
    present = np.flatnonzero(counts)
    for c in range(C):
        sel = present[counts[present] > c]
        idx_arr[c, sel] = src[starts[sel] + c]
        w_arr[c, sel] = w[starts[sel] + c]
    return TransposePlan(idx_arr, w_arr, plan.shape)


@dataclass(frozen=True)
class CSRTransposePlan:
    """Sorted-COO form of a gather plan's adjoint.

    The padded-gather :class:`TransposePlan` stores C = max contributions per
    grid pixel rows; when the local grid is denser than the global one (or
    out-of-FOV points clamp onto edge pixels — small sky grids with the real
    MIRI FOVs) C degenerates into the thousands, exploding both the table
    (C·N) and the unrolled per-row gather graph.  This form stays O(M) with
    M ≈ 4·P: per (corner, point) contribution, a (source, weight,
    destination) triple, sorted by destination, applied as ONE gather + ONE
    sorted scatter-add.
    """

    src: np.ndarray  # int32 [M] source target-point indices
    w: np.ndarray  # float [M] weights (0 = padding)
    dst: np.ndarray  # int32 [M] destination grid indices, ascending
    shape: Tuple[int, int]


def csr_transpose_plan(plan: BilinearPlan) -> CSRTransposePlan:
    """Build the sorted-COO transpose of a plan (host, once)."""
    ncorner, P = plan.idx.shape
    src = np.tile(np.arange(P, dtype=np.int64), ncorner)
    dst = plan.idx.reshape(-1).astype(np.int64)
    w = plan.w.reshape(-1)
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.argsort(dst, kind="stable")
    return CSRTransposePlan(
        src[order].astype(np.int32), w[order], dst[order].astype(np.int32),
        plan.shape,
    )


def apply_csr_transpose_arrays(tsrc, tw, tdst, values, grid_shape: Tuple[int, int]):
    """Apply a :class:`CSRTransposePlan` from its arrays (traceable args).

    values: [..., P] → out [..., Na, Nb].  One gather + one sorted
    scatter-add, independent of the per-pixel contributor count.
    """
    na, nb = grid_shape
    contrib = take_ib(values, tsrc, -1) * tw
    out = jnp.zeros(values.shape[:-1] + (na * nb,), values.dtype)
    out = out.at[..., tdst].add(
        contrib, indices_are_sorted=True, unique_indices=False
    )
    return out.reshape(values.shape[:-1] + (na, nb))


def apply_transpose_plan(tplan, values, dtype=None):
    """Exact adjoint of :func:`apply_plan` (either transpose-plan form).

    values: [..., P] → out [..., Na, Nb].
    """
    if isinstance(tplan, CSRTransposePlan):
        return apply_csr_transpose_arrays(
            tplan.src, tplan.w, tplan.dst, values, tplan.shape
        )
    return apply_transpose_plan_arrays(tplan.idx, tplan.w, values, tplan.shape)


def apply_transpose_plan_arrays(tidx, tw, values, grid_shape: Tuple[int, int]):
    """Array-argument form of :func:`apply_transpose_plan`.

    Takes the (idx, w) tables directly so they can be traced values — e.g.
    per-pointing tables fed through `lax.scan` — instead of baked constants.
    """
    na, nb = grid_shape
    out = jnp.zeros(values.shape[:-1] + (na * nb,), values.dtype)
    for c in range(tidx.shape[0]):
        out = out + tw[c] * take_ib(values, tidx[c], -1)
    return out.reshape(values.shape[:-1] + (na, nb))


def grid_points(alpha_coords: np.ndarray, beta_coords: np.ndarray) -> np.ndarray:
    """Stack 2-D coordinate fields into an [P, 2] point list (row-major)."""
    return np.vstack([alpha_coords.ravel(), beta_coords.ravel()]).T


# ---------------------------------------------------------------------------
# Composed window plan: gridding ∘ SRF box-sum ∘ slit windowing as ONE gather
# ---------------------------------------------------------------------------
#
# The channel forward's "middle" (reference pipeline interpn → SRF blur →
# per-slit windowing, spectroModelChannel.py:167-233) materializes a full
# rotated local cube [W, nla, nlb], box-sums srf consecutive α rows, then
# gathers S slit windows out of it — three HBM round-trips whose indices are
# all static.  Composing them at construction collapses the chain to a single
# C·srf-tap weighted gather from the (bbox-restricted) blurred image straight
# to the slit-window outputs [S, A, sb], and its exact transpose to a single
# sorted-COO scatter — no local cube, no broadcast, no per-slit loop.


@dataclass(frozen=True)
class ComposedWindowPlan:
    """Fused gridding→box-sum→slit-window gather plan for one pointing.

    idx: int32 [C, S·A·sb] flat indices into the source patch (row-major
         over the channel's FOV bbox [ha, wb]); C = plan corners × srf.
    w:   float [C, S·A·sb] weights.
    csrc / cw / cdst: the sorted-COO exact transpose (destination ascending,
         zero-weight padding allowed), cdst into the same [ha·wb] patch.
    linv / layers: the layered-prefix exact transpose (same taps, same
         per-destination summation order as the COO — bit-identical).
         Patch pixels are statically sorted by decreasing tap count; layer
         k holds the k-th tap of every pixel that has one, so it is a
         dense PREFIX add `acc[:T_k] += w_k · vals[src_k]` with no
         scatter, and `linv` (int32 [ha·wb], untouched pixels → T_0, the
         appended zero row) unpermutes with one take.  The prefix adds
         and takes can overlap neighbouring matmul stages, where the
         monolithic sorted scatter serializes
         (scripts/layered_fused_probe.py).
    out_shape: (S, A, sb).
    patch_shape: (ha, wb).
    """

    idx: np.ndarray
    w: np.ndarray
    csrc: np.ndarray
    cw: np.ndarray
    cdst: np.ndarray
    linv: np.ndarray
    layers: Tuple[Tuple[np.ndarray, np.ndarray], ...]
    out_shape: Tuple[int, int, int]
    patch_shape: Tuple[int, int]


def compose_window_plan(
    plan: BilinearPlan,
    a_starts,
    b_starts,
    box_offset: int,
    srf: int,
    n_aout: int,
    sb: int,
    local_shape: Tuple[int, int],
    bbox: Tuple[int, int, int, int],
    dtype=np.float64,
) -> ComposedWindowPlan:
    """Build the fused plan (host, once per channel·pointing).

    window[s, a, b] = Σ_{j<srf} local[a0_s+off + a·srf + j, b0_s + b] with
    local[q] = Σ_c plan.w[c, q] · blurred[plan.idx[c, q]]; indices are
    rebased to the bbox patch (every nonzero-weight source pixel lies inside
    the bbox by construction — it was computed from exactly these taps)."""
    nla, nlb = local_shape
    a0_bb, b0_bb, ha, wb = bbox
    nb_g = plan.shape[1]
    S = len(a_starts)
    a_starts = np.asarray(a_starts, np.int64)
    b_starts = np.asarray(b_starts, np.int64)
    # local-grid flat index of every (s, a, b, j) contribution source row
    a_idx = (
        a_starts[:, None, None, None]
        + box_offset
        + np.arange(n_aout)[None, :, None, None] * srf
        + np.arange(srf)[None, None, None, :]
    )  # [S, A, 1, srf]
    b_idx = b_starts[:, None, None, None] + np.arange(sb)[None, None, :, None]
    q = (a_idx * nlb + b_idx).reshape(-1)  # [S·A·sb·srf] local flat indices
    C0 = plan.idx.shape[0]
    gidx = plan.idx[:, q].astype(np.int64)  # [C0, S·A·sb·srf] global flat
    gw = plan.w[:, q].astype(dtype)
    # rebase to the bbox patch (zero-weight taps may fall outside — clip)
    rows = np.clip(gidx // nb_g - a0_bb, 0, ha - 1)
    cols = np.clip(gidx % nb_g - b0_bb, 0, wb - 1)
    pidx = rows * wb + cols
    n_out = S * n_aout * sb
    idx = pidx.reshape(C0, n_out, srf).transpose(0, 2, 1).reshape(C0 * srf, n_out)
    w = gw.reshape(C0, n_out, srf).transpose(0, 2, 1).reshape(C0 * srf, n_out)
    # Merge duplicate taps per output: consecutive srf rows land in adjacent
    # interpolation cells, so they share ~2 of 4 corners — the raw 4·srf
    # taps hold only ~2·(srf+1) unique source pixels.  Sum weights of equal
    # indices, then compact columns to the max unique count (the gather cost
    # scales with C, measured slower than the staged pipeline without this).
    order = np.argsort(idx, axis=0, kind="stable")
    si = np.take_along_axis(idx, order, axis=0)
    sw = np.take_along_axis(w, order, axis=0).copy()
    C_raw = si.shape[0]
    for k in range(C_raw - 1):
        dup = si[k + 1] == si[k]
        sw[k + 1] = np.where(dup, sw[k + 1] + sw[k], sw[k + 1])
        sw[k] = np.where(dup, 0, sw[k])
    compact = np.argsort(sw == 0, axis=0, kind="stable")  # nonzero first
    si = np.take_along_axis(si, compact, axis=0)
    sw = np.take_along_axis(sw, compact, axis=0)
    c_max = max(1, int((sw != 0).sum(axis=0).max()))
    idx = np.where(sw[:c_max] != 0, si[:c_max], 0)
    w = sw[:c_max]
    # exact transpose as sorted COO over the same taps
    src = np.tile(np.arange(n_out, dtype=np.int64), idx.shape[0])
    dst = idx.reshape(-1)
    ww = w.reshape(-1)
    keep = ww != 0
    src, dst, ww = src[keep], dst[keep], ww[keep]
    order = np.argsort(dst, kind="stable")
    csrc = src[order].astype(np.int32)
    cw = np.ascontiguousarray(ww[order])
    cdst = dst[order].astype(np.int32)
    # layered-prefix transpose: pixels sorted by decreasing tap count
    n_patch = ha * wb
    seg = np.bincount(cdst, minlength=n_patch)
    starts = np.concatenate([[0], np.cumsum(seg)])
    perm = np.argsort(-seg, kind="stable")
    n_layers = int(seg.max()) if cdst.size else 0
    layers = []
    for k in range(n_layers):
        t_k = int((seg > k).sum())
        sel = starts[:-1][perm[:t_k]] + k
        layers.append((csrc[sel].copy(), cw[sel].copy()))
    t0 = layers[0][0].shape[0] if layers else 0
    linv = np.full(n_patch, t0, np.int32)
    if layers:
        linv[perm[:t0]] = np.arange(t0, dtype=np.int32)
    return ComposedWindowPlan(
        idx=idx.astype(np.int32),
        w=np.ascontiguousarray(w),
        csrc=csrc,
        cw=cw,
        cdst=cdst,
        linv=linv,
        layers=tuple(layers),
        out_shape=(S, n_aout, sb),
        patch_shape=(ha, wb),
    )


def apply_composed_plan(cidx, cw, patch_flat):
    """patch_flat [..., ha·wb] → windows [..., S·A·sb] (weighted gather).

    One fused take over all C taps + a weighted contraction, instead of C
    dependent take-accumulate steps (the unrolled spelling serializes C
    gathers)."""
    C, n_out = cidx.shape
    # 2-D index take: [..., C, n_out] directly (no flat-gather + reshape)
    g = take_ib(patch_flat, cidx, -1)
    return jnp.einsum("...cp,cp->...p", g, cw,
                      precision=gemm_precision())


def apply_composed_plan_t(csrc, cw, cdst, values, patch_pixels: int):
    """Exact transpose: values [..., S·A·sb] → patch [..., ha·wb]."""
    contrib = take_ib(values, csrc, -1) * cw
    out = jnp.zeros(values.shape[:-1] + (patch_pixels,), values.dtype)
    return out.at[..., cdst].add(
        contrib, indices_are_sorted=True, unique_indices=False
    )


def apply_composed_plan_layered_t(linv, layers, values):
    """Layered-prefix exact transpose: values [W, n_out] → patch [W, P].

    layers[k] = (src [T_k], w [T_k]) with T_0 ≥ T_1 ≥ …; each layer is a
    row-gather of the transposed values plus a dense prefix add — no
    scatter op anywhere, so XLA overlaps it with neighboring matmul stages
    (the monolithic sorted-COO scatter serializes; PERF.md).  `linv`
    unpermutes (untouched pixels point at the appended zero row T_0).
    Bit-identical to :func:`apply_composed_plan_t`: per destination the
    taps accumulate in the same (stable COO segment) order.
    """
    w_dim = values.shape[0]
    vt = values.T  # [n_out, W]
    t0 = layers[0][0].shape[0]
    acc = jnp.zeros((t0, w_dim), values.dtype)
    for src, w in layers:
        upd = take_ib(vt, src, 0) * w[:, None]
        acc = acc.at[: src.shape[0]].add(upd)
    accz = jnp.concatenate([acc, jnp.zeros((1, w_dim), values.dtype)], axis=0)
    return take_ib(accz, linv, 0).T


def bucket_layers(sizes, frac: float = 0.5):
    """Group prefix-ordered layer indices into padding-efficient buckets.

    `sizes` are the layer lengths T_0 ≥ T_1 ≥ … of a layered-prefix
    transpose plan; a new bucket starts whenever a layer is smaller than
    `frac` of its bucket's head layer.  Within a bucket every layer pads to
    the head size, so the padding waste stays < 1/frac while the number of
    accumulator passes drops from L to the bucket count (≈3 at flagship
    scale vs L=7)."""
    buckets, cur = [], [0]
    for i in range(1, len(sizes)):
        if sizes[i] < frac * sizes[cur[0]]:
            buckets.append(cur)
            cur = [i]
        else:
            cur.append(i)
    buckets.append(cur)
    return buckets


def rows_from_layers(layers, dtype, frac: float = 0.5):
    """Re-spell a layered-prefix transpose plan in bucketed ROW form.

    The layered spelling updates a [T_0, W] accumulator once per layer
    (L sequential prefix adds — XLA copies the buffer per update, a large
    memory-traffic term of the flagship adjoint).  But row
    i of the accumulator is simply ``Σ_l vt[src_l[i]] · w_l[i]`` over the
    layers that reach it — a fixed-fan-in gather-weighted-sum, the same
    shape as the FORWARD composed gather.  This packs the layers into a few
    padded buckets [(SRC [Lg, Tg], WGT [Lg, Tg]), …] (padding: src 0 /
    weight 0, adds nothing) consumed by one fused take+einsum per bucket.
    """
    sizes = [np.asarray(s).shape[0] for s, _ in layers]
    out = []
    for grp in bucket_layers(sizes, frac):
        tg = sizes[grp[0]]
        src_g = np.zeros((len(grp), tg), np.asarray(layers[0][0]).dtype)
        wgt_g = np.zeros((len(grp), tg), dtype)
        for j, l in enumerate(grp):
            s, w = layers[l]
            src_g[j, : s.shape[0]] = s
            wgt_g[j, : w.shape[0]] = w
        out.append((src_g, wgt_g))
    return out


def apply_composed_plan_rows_t(linv, buckets, values):
    """Bucketed-row exact transpose: values [W, n_out] → patch [W, P].

    Same linear map (and per-destination tap set) as
    :func:`apply_composed_plan_layered_t`, spelled as one fused
    take+einsum per BUCKET instead of one prefix add per layer — the
    accumulator is written ≈3 times instead of L, cutting the adjoint's
    memory traffic.  Only the in-bucket
    reduction order differs (≤1e-15-class in f64)."""
    w_dim = values.shape[0]
    vt = values.T  # [n_out, W]
    t0 = buckets[0][0].shape[1]
    acc = jnp.zeros((t0, w_dim), values.dtype)
    for src_g, wgt_g in buckets:
        g = take_ib(vt, src_g.reshape(-1), 0)
        g = g.reshape(src_g.shape + (w_dim,))
        part = jnp.einsum(
            "ltw,lt->tw", g, wgt_g, precision=gemm_precision()
        )
        acc = acc.at[: src_g.shape[1]].add(part)
    accz = jnp.concatenate([acc, jnp.zeros((1, w_dim), values.dtype)], axis=0)
    return take_ib(accz, linv, 0).T


def banded_from_coo(
    csrc, cw, cdst, n_patch: int, n_out: int,
    tb: int = 256, sw: int = 128, dtype=np.float64, nb_total=None,
):
    """Banded-matmul respelling of the composed transpose (host, once).

    The rows/layered forms gather one vt row per TAP (~2.4·t0 single rows
    of Q≈20-24 f32, each charged a full aligned memory transaction).  But
    the taps are geometrically
    local: ordering destination rows by their first tap's source index,
    every block of `tb` consecutive rows reads from a window of ~60
    consecutive sources (slit-α-β locality; slit-crossing shared-edge taps
    are the non-local tail).  This packs the local majority into NB dense
    banded weight blocks [tb, sw] consumed as ONE batched matmul
    against contiguous vt windows — the per-tap row gather disappears —
    and keeps the tail as a sorted scatter-add of the few non-local taps.

    Returns host arrays ``(linv_b, idx, wb, osrc, ow, odst)`` for
    :func:`apply_composed_plan_banded_t`; `nb_total` pads the block count
    (for stacking pointings with differing NB).  The appended zero row of
    the accumulator lives at ``nb·tb`` — untouched pixels and padding
    point there.
    """
    csrc = np.asarray(csrc, np.int64)
    cw = np.asarray(cw)
    cdst = np.asarray(cdst, np.int64)
    keep = cw != 0
    csrc, cw, cdst = csrc[keep], cw[keep], cdst[keep]
    touched, first_pos = np.unique(cdst, return_index=True)
    key = csrc[first_pos]
    order = np.argsort(key, kind="stable")
    t0 = touched.size
    nb = max(1, -(-t0 // tb))
    if nb_total is not None:
        assert nb_total >= nb, (nb_total, nb)
        nb = int(nb_total)
    nbt = nb * tb
    rank_of = np.full(n_patch, nbt, np.int64)
    rank_of[touched[order]] = np.arange(t0)
    sw_eff = min(sw, n_out)

    r = rank_of[cdst]
    block = r // tb
    # per-block source-window start: median tap source, clipped
    starts = np.zeros(nb, np.int64)
    ord_b = np.argsort(block, kind="stable")
    bounds = np.searchsorted(block[ord_b], np.arange(nb + 1))
    smax = max(n_out - sw_eff, 0)
    for b in range(nb):
        lo, hi = bounds[b], bounds[b + 1]
        if lo == hi:
            continue
        starts[b] = np.clip(
            int(np.median(csrc[ord_b[lo:hi]])) - sw_eff // 2, 0, smax
        )
    off = csrc - starts[block]
    local = (off >= 0) & (off < sw_eff)

    wb = np.zeros((nb, tb, sw_eff), dtype)
    np.add.at(
        wb,
        (block[local], r[local] - block[local] * tb, off[local]),
        cw[local].astype(dtype),
    )
    nl = ~local
    if nl.any():
        o_order = np.argsort(r[nl], kind="stable")
        osrc = csrc[nl][o_order].astype(np.int32)
        ow = cw[nl][o_order].astype(dtype)
        odst = r[nl][o_order].astype(np.int32)
    else:
        osrc = np.zeros(1, np.int32)
        ow = np.zeros(1, dtype)
        odst = np.full(1, nbt, np.int32)
    idx = (starts[:, None] + np.arange(sw_eff)[None, :]).astype(np.int32)
    linv_b = rank_of.astype(np.int32)
    return linv_b, idx, wb, osrc, ow, odst


def apply_composed_plan_banded_t(linv, idx, wb, osrc, ow, odst, values):
    """Banded exact transpose: values [W, n_out] → patch [W, P].

    Same linear map as :func:`apply_composed_plan_t` (per destination the
    taps sum in window-position order, a ≤7-term reorder — f64-noise
    class).  One contiguous-window gather + one batched matmul for
    the local taps, a short sorted scatter-add for the non-local tail,
    one permutation take out."""
    w_dim = values.shape[0]
    vt = values.T  # [n_out, W]
    nb, tb, sw = wb.shape
    g = take_ib(vt, idx, 0)  # 2-D index take: [nb, sw, w] directly
    acc = jnp.einsum("bts,bsw->btw", wb, g, precision=gemm_precision())
    acc = acc.reshape(nb * tb, w_dim)
    accz = jnp.concatenate([acc, jnp.zeros((1, w_dim), values.dtype)], axis=0)
    contrib = take_ib(vt, osrc, 0) * ow[:, None]
    accz = accz.at[odst].add(
        contrib, indices_are_sorted=True, unique_indices=False
    )
    return take_ib(accz, linv, 0).T


def banded_cat_from_stack(linv_s, idx_s, wb_s, osrc_s, ow_s, odst_s,
                          n_out: int):
    """Cross-pointing concatenated spelling of the banded transpose (host).

    The round-4 device trace pinned ~19 % of the flagship app on gather
    ISSUE cost (~1200 instances at ~15 µs; PERF.md "Trace find #3"), with
    the count set by the per-(channel, pointing) op structure.  This
    spelling shares ONE gather / scatter / take instruction across the
    pointing axis at the INDEX level: the per-pointing tables (already
    stacked and shape-unified) get row offsets into pointing-concatenated
    sources, so the window gather, the tail scatter and the unperm take
    each run once per channel instead of once per pointing — with NO
    relayout of the lane axis (unlike `banded_mp_from_coo`, whose
    [nb, sw, P, w] repack measurably lost; PERF.md "banded_mp").

    Inputs are the 6 stacked arrays of a per-pointing banded build
    (`banded_from_coo` results stacked over P).  Index remaps:
    * window gather rows: pointing p reads vt rows [p·n_out, (p+1)·n_out)
      of the concatenated [P·n_out, W] value matrix;
    * accumulator rows: pointing p owns [p·nbt, (p+1)·nbt); ONE zero row
      is appended at P·nbt.  BOTH tail-scatter padding entries
      (odst == nbt, weight 0) and unperm (`linv`) padding remap to that
      global zero row — the tail padding could harmlessly +0 onto the
      next pointing's row 0, but a non-finite value in the data would
      then poison a REAL row (0 × NaN = NaN), so padding stays on the
      discarded row at the cost of a non-ascending scatter order.
    """
    linv_s = np.asarray(linv_s)
    odst_s = np.asarray(odst_s, np.int64)
    P, n_patch = linv_s.shape
    nb, tb = wb_s.shape[1], wb_s.shape[2]
    nbt = nb * tb
    offs_out = np.arange(P, dtype=np.int64) * n_out
    idx_cat = (np.asarray(idx_s, np.int64)
               + offs_out[:, None, None]).astype(np.int32)
    osrc_cat = (np.asarray(osrc_s, np.int64)
                + offs_out[:, None]).astype(np.int32)
    offs_acc = np.arange(P, dtype=np.int64) * nbt
    odst_cat = odst_s + offs_acc[:, None]
    odst_cat[odst_s == nbt] = P * nbt
    linv_cat = np.asarray(linv_s, np.int64) + offs_acc[:, None]
    linv_cat[linv_s == nbt] = P * nbt
    return (linv_cat.astype(np.int32), idx_cat, np.asarray(wb_s),
            osrc_cat, np.asarray(ow_s), odst_cat.astype(np.int32))


def apply_composed_plan_banded_cat_t(linv_cat, idx_cat, wb_s, osrc_cat,
                                     ow_s, odst_cat, values_s):
    """Pointing-concatenated banded transpose: values [P, W, n_out] →
    patch [W, n_patch], pointing-summed.

    Same per-(pointing, destination) tap order as P calls of
    :func:`apply_composed_plan_banded_t`; only the final pointing sum
    moves from incremental patch adds into the unperm take's reduction
    (f32 reduction-order noise).  One gather + one batched matmul +
    one sorted scatter + one take for ALL pointings."""
    P, w_dim, n_out = values_s.shape
    vt = jnp.transpose(values_s, (0, 2, 1)).reshape(P * n_out, w_dim)
    nb, tb = wb_s.shape[1], wb_s.shape[2]
    g = take_ib(vt, idx_cat, 0)  # [P, nb, sw, W] — one gather instruction
    acc = jnp.einsum("pbts,pbsw->pbtw", wb_s, g, precision=gemm_precision())
    acc = acc.reshape(P * nb * tb, w_dim)
    accz = jnp.concatenate(
        [acc, jnp.zeros((1, w_dim), values_s.dtype)], axis=0)
    contrib = take_ib(vt, osrc_cat.reshape(-1), 0) * ow_s.reshape(-1)[:, None]
    # not ascending: padding entries jump to the global zero row (see
    # banded_cat_from_stack — correctness over the sorted-scatter fast path)
    accz = accz.at[odst_cat.reshape(-1)].add(
        contrib, indices_are_sorted=False, unique_indices=False
    )
    out = take_ib(accz, linv_cat, 0)  # [P, n_patch, W] — one take
    return out.sum(axis=0).T


def pack_banded_weights(wb_stack):
    """Compress stacked banded weight blocks [P, nb, tb, sw] to their
    nonzero (flat index, value) pairs.

    The dense blocks are only ~5 % nonzero at production scales (each
    destination row holds C ≲ 7 taps of its sw-wide window), yet they are
    by far the largest host→device table of the banded transpose.  The
    packed pair is ~sw/C smaller; the dense
    blocks are rebuilt ON DEVICE once at table-materialization time
    (:func:`unpack_banded_weights`).  Padding entries point at the last
    flat slot with weight 0 (the scatter-add contributes nothing and the
    per-pointing index streams stay ascending)."""
    wb_stack = np.asarray(wb_stack)
    P = wb_stack.shape[0]
    n_flat = int(np.prod(wb_stack.shape[1:]))
    flat = wb_stack.reshape(P, n_flat)
    nz = [np.flatnonzero(flat[p]) for p in range(P)]
    m = max(1, max(i.size for i in nz))
    nzi = np.full((P, m), n_flat - 1, np.int32)
    nzv = np.zeros((P, m), wb_stack.dtype)
    for p, i in enumerate(nz):
        nzi[p, : i.size] = i
        nzv[p, : i.size] = flat[p, i]
    return nzi, nzv


def unpack_banded_weights(nzi, nzv, block_shape):
    """Rebuild dense banded weight blocks [P, *block_shape] (jittable).

    Exact inverse of :func:`pack_banded_weights`: one sorted scatter-add
    into zeros, run once per model on device — the hot-path banded matmul
    then consumes the dense blocks exactly as before."""
    n_flat = int(np.prod(block_shape))
    flat = jnp.zeros((nzi.shape[0], n_flat), nzv.dtype)
    flat = flat.at[jnp.arange(nzi.shape[0])[:, None], nzi].add(
        nzv, indices_are_sorted=True, unique_indices=False
    )
    return flat.reshape((nzi.shape[0],) + tuple(block_shape))


def banded_mp_from_coo(
    coos, n_patch: int, n_out: int,
    tb: int = 256, sw: int = 128, dtype=np.float64,
):
    """Multi-pointing banded transpose with ONE shared destination order.

    The per-pointing banded transpose (:func:`banded_from_coo`) pays its
    row-granularity-inflated ops — the final unpermuting take over the
    whole patch, the window gather, the tail scatter — once PER POINTING,
    on rows only Q≈20–24 f32 wide (the XLA cost model charges the
    flagship unperm take 0.88 GB per pointing per band-4 channel).  But
    the pointings view the same sky
    through dithers of a few pixels, so ONE destination permutation
    (touched pixels sorted by the mean-over-pointings first-tap source)
    keeps per-pointing locality, and the adjoint's sum over pointings can
    ride INSIDE the banded matmul: stacking each pointing's [tb, sw]
    weight block along the contraction axis gives one batched matmul
    with K = P·sw whose output is already pointing-summed.  The unperm
    take, accumulator traffic and tail scatter are then paid once.

    Returns host arrays ``(linv, idx, wbcat, osrc, wsel, odst)`` for
    :func:`apply_composed_plan_banded_mp_t`:

    * ``linv`` int32 [n_patch] — shared unpermutation (untouched → nb·tb);
    * ``idx`` int32 [nb, sw] — shared contiguous source windows;
    * ``wbcat`` [nb, tb, P·sw] — pointing-concatenated weight blocks;
    * ``osrc/wsel/odst`` — the merged non-local tail: tap n reads source
      row ``osrc[n]`` of the stacked values and contributes with the
      one-hot pointing selector ``wsel[n]`` (its own pointing's weight,
      zero elsewhere), dst-sorted for one scatter-add.
    """
    P = len(coos)
    cleaned = []
    for csrc, cw, cdst in coos:
        csrc = np.asarray(csrc, np.int64)
        cw = np.asarray(cw)
        cdst = np.asarray(cdst, np.int64)
        keep = cw != 0
        cleaned.append((csrc[keep], cw[keep], cdst[keep]))
    key_sum = np.zeros(n_patch)
    key_cnt = np.zeros(n_patch)
    for csrc, _, cdst in cleaned:
        touched, first_pos = np.unique(cdst, return_index=True)
        key_sum[touched] += csrc[first_pos]
        key_cnt[touched] += 1
    touched = np.flatnonzero(key_cnt > 0)
    order = np.argsort(key_sum[touched] / key_cnt[touched], kind="stable")
    t0 = touched.size
    nb = max(1, -(-t0 // tb))
    nbt = nb * tb
    rank_of = np.full(n_patch, nbt, np.int64)
    rank_of[touched[order]] = np.arange(t0)
    sw_eff = min(sw, n_out)
    smax = max(n_out - sw_eff, 0)

    # shared per-block window start: pooled median over ALL pointings' taps
    all_src = np.concatenate([c[0] for c in cleaned])
    all_blk = np.concatenate([rank_of[c[2]] // tb for c in cleaned])
    starts = np.zeros(nb, np.int64)
    ord_b = np.argsort(all_blk, kind="stable")
    bounds = np.searchsorted(all_blk[ord_b], np.arange(nb + 1))
    for b in range(nb):
        lo, hi = bounds[b], bounds[b + 1]
        if lo == hi:
            continue
        starts[b] = np.clip(
            int(np.median(all_src[ord_b[lo:hi]])) - sw_eff // 2, 0, smax
        )

    wbcat = np.zeros((nb, tb, P * sw_eff), dtype)
    t_src, t_w, t_dst, t_p = [], [], [], []
    for p, (csrc, cw, cdst) in enumerate(cleaned):
        r = rank_of[cdst]
        blk = r // tb
        off = csrc - starts[blk]
        local = (off >= 0) & (off < sw_eff)
        np.add.at(
            wbcat,
            (blk[local], r[local] - blk[local] * tb,
             p * sw_eff + off[local]),
            cw[local].astype(dtype),
        )
        nl = ~local
        t_src.append(csrc[nl])
        t_w.append(cw[nl])
        t_dst.append(r[nl])
        t_p.append(np.full(int(nl.sum()), p, np.int64))
    osrc = np.concatenate(t_src)
    ow = np.concatenate(t_w)
    odst = np.concatenate(t_dst)
    opt = np.concatenate(t_p)
    if osrc.size:
        o_order = np.argsort(odst, kind="stable")
        osrc, ow, odst, opt = (
            osrc[o_order], ow[o_order], odst[o_order], opt[o_order]
        )
    else:
        osrc = np.zeros(1, np.int64)
        ow = np.zeros(1, dtype)
        odst = np.full(1, nbt, np.int64)
        opt = np.zeros(1, np.int64)
    wsel = np.zeros((osrc.size, P), dtype)
    wsel[np.arange(osrc.size), opt] = ow.astype(dtype)
    idx = (starts[:, None] + np.arange(sw_eff)[None, :]).astype(np.int32)
    return (rank_of.astype(np.int32), idx, wbcat,
            osrc.astype(np.int32), wsel, odst.astype(np.int32))


def apply_composed_plan_banded_mp_t(linv, idx, wbcat, osrc, wsel, odst,
                                    vals_stack):
    """Pointing-summed banded transpose: vals [P, W, n_out] → patch [W, P_px].

    One window gather of P·W-wide rows, ONE batched matmul with the
    pointing axis folded into the contraction (output already summed over
    pointings), one merged tail scatter, one unperm take.  Same linear map
    as summing P :func:`apply_composed_plan_banded_t` calls (per
    destination the taps merely sum in a different order — rounding-noise
    class; equivalence is test-pinned)."""
    P, w_dim, n_out = vals_stack.shape
    nb, tb, psw = wbcat.shape
    sw = psw // P
    vt = jnp.transpose(vals_stack, (2, 0, 1)).reshape(n_out, P * w_dim)
    g = take_ib(vt, idx.reshape(-1), 0).reshape(nb, sw, P, w_dim)
    g = jnp.transpose(g, (0, 2, 1, 3)).reshape(nb, P * sw, w_dim)
    acc = jnp.einsum("btk,bkw->btw", wbcat, g, precision=gemm_precision())
    acc = acc.reshape(nb * tb, w_dim)
    accz = jnp.concatenate(
        [acc, jnp.zeros((1, w_dim), vals_stack.dtype)], axis=0)
    gt = take_ib(vt, osrc, 0).reshape(-1, P, w_dim)
    contrib = jnp.einsum("npw,np->nw", gt, wsel,
                         precision=gemm_precision())
    accz = accz.at[odst].add(
        contrib, indices_are_sorted=True, unique_indices=False
    )
    return take_ib(accz, linv, 0).T


def batch_composed_plan(cidx, cw):
    """Fold stacked per-pointing gather tables [P, C, n_out] into one
    pointing-batched plan [C, P·n_out].

    The P pointings gather from the SAME source patch, so concatenating
    their output axes yields one bigger gather/contraction instead of P
    small ones — fewer op instances per compiled program, identical taps
    in identical order (bit-exact; PERF.md "pointing-batched composed
    plan")."""
    P, C, n_out = cidx.shape
    return (
        np.transpose(np.asarray(cidx), (1, 0, 2)).reshape(C, P * n_out),
        np.transpose(np.asarray(cw), (1, 0, 2)).reshape(C, P * n_out),
    )


def batch_composed_layered_t(linv, parts, n_out):
    """Fold stacked per-pointing layered-transpose tables into one
    pointing-batched table set.

    `linv` [P, n_patch] and `parts` = (src_0 [P, T_0], w_0, src_1, w_1, …)
    as stacked by the Channel constructor; `n_out` is the per-pointing
    window-value count S·A·sb the layer sources index into.  Returns
    ``(P, linv_b [P, n_patch], src_0b [T_0·P], w_0b, …)`` with per-pointing
    row offsets baked into the indices.  Layer sources index the flattened
    [P·n_out] value matrix (pointing-major, matching the batched wblur_t
    output layout) but are emitted TAP-major / pointing-minor so each
    layer's update lands on a contiguous row-prefix of the interleaved
    [T_0·P(+P), W] accumulator — a strided [:, :T_k] slab update across a
    [P, T_0, W] accumulator makes XLA copy the whole buffer per layer,
    which is exactly the traffic the layered form exists to avoid.
    `linv_b` indexes that interleaved accumulator (row t·P + p; the P
    appended zero rows sit at T_0·P + p)."""
    linv = np.asarray(linv)
    P = linv.shape[0]
    srcs, ws = parts[0::2], parts[1::2]
    t0 = int(np.asarray(srcs[0]).shape[1])
    out = [P, np.stack([np.asarray(linv[p]) * P + p for p in range(P)])]
    for s, w in zip(srcs, ws):
        s = np.asarray(s)
        w = np.asarray(w)
        offs = (np.arange(P) * n_out)[:, None].astype(s.dtype)
        out.append(np.ascontiguousarray((s + offs).T).reshape(-1))
        out.append(np.ascontiguousarray(w.T).reshape(-1))
    return tuple(out)


def apply_composed_plan_layered_t_batched(n_pt, linv_b, layers, values):
    """Pointing-batched twin of :func:`apply_composed_plan_layered_t`:
    values [W, P·n_out] → per-pointing patches [P, n_patch, W].

    One take + one dense prefix add per LAYER (instead of per layer per
    pointing); the caller sums the P patches (the adjoint accumulation
    across pointings).  The accumulator interleaves pointings tap-major
    (rows t·P + p) so every layer update is a contiguous row-prefix add,
    same as the unbatched form — same taps, same per-destination
    accumulation order."""
    w_dim = values.shape[0]
    vt = values.T  # [P·n_out, W]
    t0 = layers[0][0].shape[0] // n_pt
    acc = jnp.zeros((t0 * n_pt, w_dim), values.dtype)
    for src, w in layers:
        upd = take_ib(vt, src, 0) * w[:, None]
        acc = acc.at[: src.shape[0]].add(upd)
    accz = jnp.concatenate(
        [acc, jnp.zeros((n_pt, w_dim), values.dtype)], axis=0
    )
    return take_ib(accz, linv_b.reshape(-1), 0).reshape(
        n_pt, linv_b.shape[1], w_dim
    )
