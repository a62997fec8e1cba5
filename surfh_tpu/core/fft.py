"""Unitary Fourier transforms and transfer-function helpers.

Replaces the reference's twin FFT stacks (`surfh/ToolsDir/jax_utils.py:30-57`
scipy twins `surfh/ToolsDir/python_utils.py:40-71`) and the slivers of the
`udft` companion package the reference relies on (`udft.ir2fr`,
`udft.laplacian`).  Everything here runs under jit on the device; XLA maps the
batched 2-D real FFTs onto fused per-plane kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def dft(inarray):
    """Unitary real DFT over the last two axes."""
    return jnp.fft.rfftn(inarray, axes=(-2, -1), norm="ortho")


def idft(inarray, im_shape: Tuple[int, int]):
    """Unitary inverse real DFT over the last ``len(im_shape)`` axes."""
    return _idft(inarray, tuple(im_shape))


@jax.jit
def dft_mult(a, b):
    """rfft2(a) * b — fused for convenience."""
    return jnp.fft.rfftn(a, axes=(-2, -1), norm="ortho") * b


from functools import partial


@partial(jax.jit, static_argnums=1)
def _idft(inarray, im_shape):
    axes = tuple(range(-len(im_shape), 0))
    return jnp.fft.irfftn(inarray, s=im_shape, axes=axes, norm="ortho")


@partial(jax.jit, static_argnums=2)
def idft_mult(a, b, im_shape):
    return _idft(a * b, tuple(im_shape))


def convolve_freq(cube, otf, im_shape: Tuple[int, int]):
    """Circular convolution of each plane of `cube` with transfer function `otf`.

    `otf` must be a *non-unitary* transfer function from :func:`ir2fr`; with the
    unitary dft/idft pair the result is the plain circular convolution with the
    impulse response (the reference's C operator,
    /root/reference/surfh/Models/spectroModel.py:166).
    """
    return idft(dft(cube) * otf, im_shape)


def ir2fr(imp_resp: np.ndarray, shape: Tuple[int, int], center=None, real: bool = True) -> np.ndarray:
    """Transfer function of an impulse response, centered, non-unitary.

    NumPy/host-side (run once at model construction).  Matches the `udft.ir2fr`
    semantics the reference uses to build `sotf` and `_otf_sr`
    (/root/reference/surfh/Models/spectroModelChannel.py:81-83): pad the
    impulse response to `shape`, roll its center to index (0, 0), and take the
    non-normalized real FFT over the trailing ``len(shape)`` axes.
    """
    imp_resp = np.asarray(imp_resp)
    ndim_s = len(shape)
    if center is None:
        center = [length // 2 for length in imp_resp.shape[-ndim_s:]]
    padded = np.zeros(imp_resp.shape[:-ndim_s] + tuple(shape), dtype=imp_resp.dtype)
    padded[tuple(slice(0, s) for s in imp_resp.shape)] = imp_resp
    for ax, shift in enumerate(center):
        padded = np.roll(padded, -shift, imp_resp.ndim - ndim_s + ax)
    axes = list(range(imp_resp.ndim - ndim_s, imp_resp.ndim))
    if real:
        return np.fft.rfftn(padded, axes=axes)
    return np.fft.fftn(padded, axes=axes)


def laplacian(ndim: int) -> np.ndarray:
    """Discrete Laplacian impulse response (sum of 1-D [-1, 2, -1] stencils)."""
    lapl = np.zeros((3,) * ndim)
    for dim in range(ndim):
        idx = tuple(
            [slice(1, 2)] * dim + [slice(None)] + [slice(1, 2)] * (ndim - dim - 1)
        )
        lapl[idx] += np.array([-1.0, 2.0, -1.0]).reshape(
            [-1 if i == dim else 1 for i in range(ndim)]
        )
    return lapl


def box_otf_sr(srf: int, im_shape: Tuple[int, int], dtype=np.complex64) -> np.ndarray:
    """OTF of the [srf, 1] box used to accumulate `srf` oversampled α rows.

    Reference: `_otf_sr` at /root/reference/surfh/Models/spectroModelChannel.py:81.
    """
    return ir2fr(np.ones((srf, 1)), im_shape)[np.newaxis, ...].astype(dtype)


def half_srf_shift_otf(srf: int, im_shape: Tuple[int, int], dtype=np.complex64) -> np.ndarray:
    """Pure-phase OTF shifting by (srf-1)//2 along α (the `decalf` trick).

    The reference builds a dirac at index [-(srf-1)//2, 0] scaled by
    sqrt(N1·N2) and takes its unitary DFT
    (/root/reference/surfh/Models/spectroModelChannel.py:104-108); the scaling
    makes it a unit-modulus phase ramp.  Computed numerically the same way for
    bit parity.
    """
    decal = np.zeros(im_shape)
    dsi = int((srf - 1) / 2)
    decal[-dsi if dsi else 0, 0] = np.sqrt(im_shape[0] * im_shape[1])
    return np.fft.rfftn(decal, axes=(-2, -1), norm="ortho").astype(dtype)


# ---------------------------------------------------------------------------
# Matmul-form DFT convolution (the flagship conv path)
#
# Recasting the 2-D DFT as explicit matmuls costs ~N/log N more FLOPs than
# an FFT, but it admits what the FFT cannot: frequency-support truncation,
# a spatial output restricted to the field-of-view bbox, PSF-stamp OTFs
# evaluated in-graph, and the λ-rank factorization.  At f32
# (`precision="highest"`) its max rel deviation from the FFT is 7.1e-6 —
# float32-class; in float64 (CPU tests) the matrices are exact to ~1e-13,
# so parity contracts are unaffected.  Whether cuFFT on the rank planes
# beats it on the GPU is an open measurement (ROADMAP).
#
# Layout: x [W, Na, Nb] real; OTF one-sided [W, Na, Kb] (Kb = Nb//2+1) as a
# (re, im) pair of real arrays.


def dft_matmul_tables(
    im_shape: Tuple[int, int],
    dtype=np.float32,
    ka_max: Optional[int] = None,
    kb_keep: Optional[int] = None,
    bbox: Optional[Tuple[int, int, int, int]] = None,
) -> dict:
    """Host-side DFT matrices for :func:`conv_otf_matmul` (and transpose).

    Equivalent to the non-unitary rfft2/irfft2 pair used by
    :func:`convolve_freq` (the unitary pair's 1/N factors cancel in the
    forward∘inverse composition).  ~6 N² floats, shared by all channels.

    `ka_max` / `kb_keep` restrict the frequency-domain stages to the OTF's
    support (see :func:`otf_freq_support`): only α bins with
    ``|signed freq| <= ka_max`` and the first `kb_keep` one-sided β bins are
    computed.  The OTF must then be sliced to the same support
    (``otf[..., sel_a, :kb_keep]`` with ``sel_a = freq_sel_alpha(na, ka_max)``).
    The truncated pair stays an exact forward/transpose couple (dot-tests
    hold at machine precision); its deviation from the full convolution is
    bounded by the dropped OTF magnitude — ~0 for band-limited PSFs.

    `bbox` = (a0, b0, ha, wb) restricts the conv's *spatial output* (and the
    transpose's spatial input) to a window of the grid: the inverse-DFT
    matrices keep only the bbox rows, so :func:`conv_otf_matmul` returns
    [..., ha, wb] — the computed elements are bit-identical to the full
    output's window (each output element is the same dot product).  Used
    when the downstream consumer (the gridding gather) only ever reads the
    instrument-footprint bbox (~10% of the flagship sky grid) — an exact
    restriction no FFT can express.
    """
    na, nb = int(im_shape[0]), int(im_shape[1])
    kb = nb // 2 + 1
    if kb_keep is None or kb_keep > kb:
        kb_keep = kb
    kb_keep = max(int(kb_keep), 1)
    a = np.arange(na)
    b = np.arange(nb)
    sel_a = freq_sel_alpha(na, ka_max)
    fb = np.exp(-2j * np.pi * np.outer(np.arange(kb_keep), b) / nb)  # [Kb', Nb]
    fa = np.exp(-2j * np.pi * np.outer(sel_a, a) / na)  # [Ka', Na]
    ifa = np.conj(fa).T / na  # [Na, Ka']
    cb = np.exp(2j * np.pi * np.outer(b, np.arange(kb_keep)) / nb)  # [Nb, Kb']
    if bbox is not None:
        a0, b0, ha, wb = (int(v) for v in bbox)
        ifa = ifa[a0 : a0 + ha]  # spatial output rows → bbox α rows
        cb = cb[b0 : b0 + wb]  # spatial output cols → bbox β cols
    wgt = np.ones(kb_keep)
    wgt[1:] = 2.0
    if nb % 2 == 0 and kb_keep == kb:
        wgt[-1] = 1.0  # even Nb: the Nyquist bin is not doubled
    # fa_d/fa_s (and ifa_*) support the 3-multiplication Gauss form of the
    # complex α-stage: k1=A(u+v), k2=(B−A)u, k3=(A+B)v → re=k1−k3, im=k1+k2
    # (3 matmuls instead of 4; identical linear map).
    return {
        "fb_re": fb.real.astype(dtype),
        "fb_im": fb.imag.astype(dtype),
        "fa_re": fa.real.astype(dtype),
        "fa_d": (fa.imag - fa.real).astype(dtype),
        "fa_s": (fa.real + fa.imag).astype(dtype),
        "ifa_re": ifa.real.astype(dtype),
        "ifa_d": (ifa.imag - ifa.real).astype(dtype),
        "ifa_s": (ifa.real + ifa.imag).astype(dtype),
        "icb_re": (cb.real * wgt / nb).astype(dtype),
        "icb_im": (cb.imag * wgt / nb).astype(dtype),
    }


def freq_sel_alpha(na: int, ka_max: Optional[int]) -> np.ndarray:
    """α-axis DFT bin indices with |signed frequency| ≤ `ka_max`.

    The full-spectrum index a ∈ [0, Na) carries signed frequency
    min(a, Na−a); the kept set is the union of the low-frequency prefix and
    the (negative-frequency) suffix.  `ka_max=None` keeps every bin.
    """
    a = np.arange(na)
    if ka_max is None:
        return a
    sfreq = np.minimum(a, na - a)
    return np.nonzero(sfreq <= int(ka_max))[0]


def psf_stamp_tables(
    im_shape: Tuple[int, int],
    stamp_shape: Tuple[int, int],
    dtype=np.float32,
    ka_max: Optional[int] = None,
    kb_keep: Optional[int] = None,
    center=None,
) -> dict:
    """DFT-at-stamp matrices: evaluate a padded+centered PSF's OTF directly.

    ``otf[w, c, k] = Σ_{x,y} psf[w, x, y] · e^{-2πi·sel_a[c]·(x−cx)/Na}
    · e^{-2πi·k·(y−cy)/Nb}`` — the closed form of ``ir2fr(psf, im_shape)``
    (pad to the grid, roll the center to (0,0), non-unitary rFFT) sampled
    only at the kept frequency bins.  A flagship PSF stamp is 40×40 while
    the OTF window is ~300 MB/channel: shipping stamps + evaluating on
    device via :func:`otf_from_stamps` replaces a ~GB-scale upload and
    the host-side full-grid FFT precompute with two tiny einsums per
    application.
    """
    na, nb = int(im_shape[0]), int(im_shape[1])
    sx, sy = int(stamp_shape[0]), int(stamp_shape[1])
    kb = nb // 2 + 1
    if kb_keep is None or kb_keep > kb:
        kb_keep = kb
    kb_keep = max(int(kb_keep), 1)
    if center is None:
        center = (sx // 2, sy // 2)
    cx, cy = int(center[0]), int(center[1])
    sel_a = freq_sel_alpha(na, ka_max)
    sa = np.exp(-2j * np.pi * np.outer(sel_a, np.arange(sx) - cx) / na)
    sb = np.exp(-2j * np.pi * np.outer(np.arange(sy) - cy, np.arange(kb_keep)) / nb)
    return {
        "sa_re": sa.real.astype(dtype),
        "sa_im": sa.imag.astype(dtype),
        "sb_re": sb.real.astype(dtype),
        "sb_im": sb.imag.astype(dtype),
    }


def otf_from_stamps(psf, st: dict, precision: str = "highest"):
    """(otf_re, otf_im) of a PSF stamp stack [W, sx, sy] (see
    :func:`psf_stamp_tables`).  Jit-friendly; deterministic, so the forward
    and transpose programs compute bit-identical OTFs and stay an exact
    adjoint pair."""
    es = lambda s, p, q: jnp.einsum(s, p, q, precision=precision)
    z_re = es("wxy,cx->wcy", psf, st["sa_re"])
    z_im = es("wxy,cx->wcy", psf, st["sa_im"])
    otf_re = es("wcy,yk->wck", z_re, st["sb_re"]) - es("wcy,yk->wck", z_im, st["sb_im"])
    otf_im = es("wcy,yk->wck", z_re, st["sb_im"]) + es("wcy,yk->wck", z_im, st["sb_re"])
    return otf_re, otf_im


def lowrank_stamp_factor(psf, rtol: float, rmax: Optional[int] = None):
    """λ-rank factorization of a PSF stamp stack: psf ≈ U · V.

    The per-λ PSF varies smoothly with wavelength (σ ∝ λ for the gaussian
    model; slowly-evolving diffraction structure for webbpsf stacks), so the
    [W, sx·sy] stamp matrix is numerically low-rank: the flagship 3879-λ
    gaussian stack is rank 13 at σ_tail/σ₁ ≤ 1e-6, and per-channel λ-windows
    are lower still.  Host-side SVD; singular values are folded into `U` so
    the rows of `V` are orthonormal unit-scale stamps.

    Returns ``(U [W, R], V [R, sx, sy], tail)`` with
    ``tail = σ_{R+1}/σ₁`` — the relative operator-norm of the dropped stamp
    components, which bounds the rank-truncated convolution's relative
    deviation from the full one.  `rtol` drops components with
    ``σ_i/σ₁ ≤ rtol`` (R ≥ 1 always); `rmax` caps R.
    """
    psf = np.asarray(psf)
    W = psf.shape[0]
    A = psf.reshape(W, -1).astype(np.float64)
    Um, s, Vt = np.linalg.svd(A, full_matrices=False)
    if s[0] <= 0.0:
        R = 1
    else:
        R = max(1, int(np.sum(s / s[0] > rtol)))
    if rmax is not None:
        R = min(R, int(rmax))
    U = (Um[:, :R] * s[:R]).astype(psf.dtype)
    V = Vt[:R].reshape((R,) + psf.shape[1:]).astype(psf.dtype)
    tail = float(s[R] / s[0]) if R < len(s) and s[0] > 0.0 else 0.0
    return U, V, tail


def lmm_conv_rank(maps, otf_re, otf_im, m: dict, precision: str = "highest"):
    """Rank-basis fused T·C: DFT the M template maps, multiply by the R
    rank-basis OTFs, inverse onto the FOV bbox — WITHOUT mixing back to the
    W λ-planes.

    With the PSF stamps factored as ``psf[w] = Σ_r U[w,r]·V[r]``
    (:func:`lowrank_stamp_factor`), every λ-plane of the blurred window is a
    static linear mix of the Q = M·R basis planes
    ``Y[m,r] = IDFT(DFT(maps[m]) ⊙ OTF(V[r]))``:
    ``blurred[w] = Σ_{m,r} tpl[m,w]·U[w,r]·Y[m,r]``.  Because everything
    downstream of the conv (composed gather, slit weights) is λ-batched and
    the spectral blur contracts λ linearly, the mix is *folded into the
    wblur table* (``wpsf_q[k,q,b] = Σ_w wpsf[k,w,b]·tpl[m,w]·U[w,r]``) and
    the whole windowed pipeline runs on Q ≈ 16–64 planes instead of
    W ≈ 250–1400 — the inverse-DFT stages, the gather/scatter, and the wblur
    GEMM all shrink by W/Q.  The forward/transpose pair stays exact (the
    truncation modifies the *operator*, consistently in both directions —
    same contract as the frequency truncation, and unlike precision tricks
    it is CG-safe).

    maps [M, Na, Nb] real; otf_* [R, Ka', Kb'] = OTF of the V stamps on
    `m`'s frequency support.  Returns the rank-basis bbox patch
    [M·R, ha, wb], m-major (matching the ``reshape(M·R)`` of a [M, R] stack).
    """
    es = lambda s, p, q: jnp.einsum(s, p, q, precision=precision)
    yb_re = es("mab,kb->mak", maps, m["fb_re"])
    yb_im = es("mab,kb->mak", maps, m["fb_im"])
    k1 = es("mak,ca->mck", yb_re + yb_im, m["fa_re"])
    zm_re = k1 - es("mak,ca->mck", yb_im, m["fa_s"])
    zm_im = k1 + es("mak,ca->mck", yb_re, m["fa_d"])
    t_re = zm_re[:, None] * otf_re[None] - zm_im[:, None] * otf_im[None]
    t_im = zm_re[:, None] * otf_im[None] + zm_im[:, None] * otf_re[None]
    q_, ck = t_re.shape[0] * t_re.shape[1], t_re.shape[2:]
    t_re = t_re.reshape((q_,) + ck)
    t_im = t_im.reshape((q_,) + ck)
    k1 = es("qck,ac->qak", t_re + t_im, m["ifa_re"])
    ua_re = k1 - es("qck,ac->qak", t_im, m["ifa_s"])
    ua_im = k1 + es("qck,ac->qak", t_re, m["ifa_d"])
    return es("qak,bk->qab", ua_re, m["icb_re"]) - es("qak,bk->qab", ua_im, m["icb_im"])


def lmm_conv_rank_t(g, otf_re, otf_im, m: dict, n_maps: int, precision: str = "highest"):
    """Exact transpose of :func:`lmm_conv_rank` w.r.t. `maps`.

    g [M·R, ha, wb] (the rank-basis patch cotangent, straight from the
    gridding transpose run in the rank basis) → [M, Na, Nb].  Mechanical
    einsum-by-einsum transposition; validated against `jax.linear_transpose`
    (tests/test_kernels.py)."""
    es = lambda s, p, q: jnp.einsum(s, p, q, precision=precision)
    ua_re = es("qab,bk->qak", g, m["icb_re"])
    ua_im = -es("qab,bk->qak", g, m["icb_im"])
    k1 = es("qak,ac->qck", ua_re + ua_im, m["ifa_re"])
    t_re = k1 + es("qak,ac->qck", ua_im, m["ifa_d"])
    t_im = k1 - es("qak,ac->qck", ua_re, m["ifa_s"])
    r_ = otf_re.shape[0]
    t_re = t_re.reshape((n_maps, r_) + t_re.shape[1:])
    t_im = t_im.reshape((n_maps, r_) + t_im.shape[1:])
    zm_re = es("mrck,rck->mck", t_re, otf_re) + es("mrck,rck->mck", t_im, otf_im)
    zm_im = es("mrck,rck->mck", t_im, otf_re) - es("mrck,rck->mck", t_re, otf_im)
    k1 = es("mck,ca->mak", zm_re + zm_im, m["fa_re"])
    yb_re = k1 + es("mck,ca->mak", zm_im, m["fa_d"])
    yb_im = k1 - es("mck,ca->mak", zm_re, m["fa_s"])
    return es("mak,kb->mab", yb_re, m["fb_re"]) + es("mak,kb->mab", yb_im, m["fb_im"])


def _support_from_axis_maxima(colmax, rowmax, rtol: float):
    """Shared tail of the two support derivations: per-axis OTF magnitude
    maxima → (ka_max, kb_keep, dropped_rel).  Both the stamp-mode and the
    materialized-sotf paths MUST truncate identically, so this logic lives
    in exactly one place."""
    na, kb = len(rowmax), len(colmax)
    amax = float(colmax.max())
    if amax == 0.0 or rtol <= 0.0:
        return None, None, 0.0
    thr = rtol * amax
    keep_b = np.nonzero(colmax >= thr)[0]
    kb_keep = int(keep_b[-1]) + 1 if len(keep_b) else 1
    sfreq = np.minimum(np.arange(na), na - np.arange(na))
    keep_a = np.nonzero(rowmax >= thr)[0]
    ka_max = int(sfreq[keep_a].max()) if len(keep_a) else 0
    dropped = 0.0
    if kb_keep < kb:
        dropped = max(dropped, float(colmax[kb_keep:].max()) / amax)
    out_a = sfreq > ka_max
    if out_a.any():
        dropped = max(dropped, float(rowmax[out_a].max()) / amax)
    return ka_max, kb_keep, dropped


def otf_support_from_psf(
    psf_stack, im_shape: Tuple[int, int], rtol: float, center=None, chunk: int = 64
):
    """(ka_max, kb_keep, dropped_rel) like :func:`otf_freq_support`, computed
    from PSF stamps without materializing the full OTF window: evaluates the
    full-spectrum OTF chunk-by-chunk with float64 stamp matrices and keeps
    only per-axis magnitude maxima."""
    psf_stack = np.asarray(psf_stack)
    na, nb = int(im_shape[0]), int(im_shape[1])
    kb = nb // 2 + 1
    st = psf_stamp_tables(im_shape, psf_stack.shape[-2:], np.float64, center=center)
    sa = st["sa_re"] + 1j * st["sa_im"]
    sb = st["sb_re"] + 1j * st["sb_im"]
    colmax = np.zeros(kb)
    rowmax = np.zeros(na)
    for i in range(0, psf_stack.shape[0], chunk):
        z = np.einsum("wxy,cx->wcy", psf_stack[i : i + chunk], sa)
        mag = np.abs(np.einsum("wcy,yk->wck", z, sb))
        colmax = np.maximum(colmax, mag.max(axis=(0, 1)))
        rowmax = np.maximum(rowmax, mag.max(axis=(0, 2)))
    return _support_from_axis_maxima(colmax, rowmax, rtol)


def otf_freq_support(otf, rtol: float, chunk: int = 256):
    """(ka_max, kb_keep, dropped_rel) frequency support of an OTF stack.

    `otf` is [..., Na, Kb] (complex or a (re, im) pair on axis 0); bins whose
    peak magnitude over all leading axes falls below ``rtol·max|otf|`` are
    dropped.  `dropped_rel` is the largest dropped magnitude relative to the
    peak — the operator-norm error bound of the truncated convolution.
    Streamed in λ-chunks so memmapped flagship-scale OTFs never materialize.
    """
    otf = np.asarray(otf)
    na, kb = otf.shape[-2], otf.shape[-1]
    flat = otf.reshape(-1, na, kb)
    colmax = np.zeros(kb)
    rowmax = np.zeros(na)
    for i in range(0, flat.shape[0], chunk):
        mag = np.abs(flat[i : i + chunk])
        colmax = np.maximum(colmax, mag.max(axis=(0, 1)))
        rowmax = np.maximum(rowmax, mag.max(axis=(0, 2)))
    return _support_from_axis_maxima(colmax, rowmax, rtol)


def conv_otf_matmul(x, otf_re, otf_im, m: dict, precision: str = "highest"):
    """Circular convolution irfft2(rfft2(x) · otf) as real matmuls.

    `m` from :func:`dft_matmul_tables` (device or host).  All arithmetic is
    real-valued (re/im planes).
    """
    es = lambda s, p, q: jnp.einsum(s, p, q, precision=precision)
    yb_re = es("wab,kb->wak", x, m["fb_re"])
    yb_im = es("wab,kb->wak", x, m["fb_im"])
    # α-stage, Gauss 3M: k1=A(u+v), k2=(B−A)u, k3=(A+B)v
    k1 = es("wak,ca->wck", yb_re + yb_im, m["fa_re"])
    za_re = k1 - es("wak,ca->wck", yb_im, m["fa_s"])
    za_im = k1 + es("wak,ca->wck", yb_re, m["fa_d"])
    t_re = za_re * otf_re - za_im * otf_im
    t_im = za_re * otf_im + za_im * otf_re
    k1 = es("wck,ac->wak", t_re + t_im, m["ifa_re"])
    ua_re = k1 - es("wck,ac->wak", t_im, m["ifa_s"])
    ua_im = k1 + es("wck,ac->wak", t_re, m["ifa_d"])
    return es("wak,bk->wab", ua_re, m["icb_re"]) - es("wak,bk->wab", ua_im, m["icb_im"])


def conv_otf_matmul_t(g, otf_re, otf_im, m: dict, precision: str = "highest"):
    """Exact transpose of :func:`conv_otf_matmul` w.r.t. `x` (same OTF).

    Mechanical einsum-by-einsum transposition; validated against
    `jax.linear_transpose` at machine precision (tests/test_kernels.py).
    """
    es = lambda s, p, q: jnp.einsum(s, p, q, precision=precision)
    ua_re = es("wab,bk->wak", g, m["icb_re"])
    ua_im = -es("wab,bk->wak", g, m["icb_im"])
    # conj(M) α-stages in Gauss 3M form: k1=A(p+q);
    # re = k1 + (B−A)q, im = k1 − (A+B)p
    k1 = es("wak,ac->wck", ua_re + ua_im, m["ifa_re"])
    t_re = k1 + es("wak,ac->wck", ua_im, m["ifa_d"])
    t_im = k1 - es("wak,ac->wck", ua_re, m["ifa_s"])
    za_re = t_re * otf_re + t_im * otf_im
    za_im = -t_re * otf_im + t_im * otf_re
    k1 = es("wck,ca->wak", za_re + za_im, m["fa_re"])
    yb_re = k1 + es("wck,ca->wak", za_im, m["fa_d"])
    yb_im = k1 - es("wck,ca->wak", za_re, m["fa_s"])
    return es("wak,kb->wab", yb_re, m["fb_re"]) + es("wak,kb->wab", yb_im, m["fb_im"])


def lmm_conv_otf_matmul(maps, tpl_w, otf_re, otf_im, m: dict, precision: str = "highest"):
    """Fused T·C: irfft2(rfft2(Σ_m maps[m]·tpl[m,w]) · otf[w]) as real matmuls.

    The 2-D DFT is linear and the LMM mixes λ-planes pointwise, so the
    forward transform runs on the `M` template **maps** (M ≈ 4 planes)
    instead of the `W` mixed λ-planes (W ≈ 250–1400): the expensive
    forward-DFT stages shrink by W/M and the spatial cube T·x is never
    materialized.  Only the inverse stages (needed per λ-plane for the
    spatial gridding that follows) stay O(W).  Identical linear map to
    ``conv_otf_matmul(lmm_maps2cube(maps, tpl_w), ...)``; replaces the
    reference's sequential T-then-C (spectroModel.py:158-166) on the hot
    path.

    maps [M, Na, Nb] real; tpl_w [M, W]; otf one-sided [W, Ka', Kb'] as a
    (re, im) pair matching `m`'s (possibly truncated) frequency support.
    """
    es = lambda s, p, q: jnp.einsum(s, p, q, precision=precision)
    yb_re = es("mab,kb->mak", maps, m["fb_re"])
    yb_im = es("mab,kb->mak", maps, m["fb_im"])
    k1 = es("mak,ca->mck", yb_re + yb_im, m["fa_re"])
    zm_re = k1 - es("mak,ca->mck", yb_im, m["fa_s"])
    zm_im = k1 + es("mak,ca->mck", yb_re, m["fa_d"])
    # LMM in the Fourier domain: Z[w] = Σ_m tpl[m, w] · Zm[m]
    zw_re = es("mck,mw->wck", zm_re, tpl_w)
    zw_im = es("mck,mw->wck", zm_im, tpl_w)
    t_re = zw_re * otf_re - zw_im * otf_im
    t_im = zw_re * otf_im + zw_im * otf_re
    k1 = es("wck,ac->wak", t_re + t_im, m["ifa_re"])
    ua_re = k1 - es("wck,ac->wak", t_im, m["ifa_s"])
    ua_im = k1 + es("wck,ac->wak", t_re, m["ifa_d"])
    return es("wak,bk->wab", ua_re, m["icb_re"]) - es("wak,bk->wab", ua_im, m["icb_im"])


def lmm_conv_otf_matmul_t(g, tpl_w, otf_re, otf_im, m: dict, precision: str = "highest"):
    """Exact transpose of :func:`lmm_conv_otf_matmul` w.r.t. `maps`.

    The mirror win: the expensive inverse-DFT stages run on M template
    planes (the λ-sum Σ_w tpl[m,w]·(·) commutes with the inverse transform),
    only the forward stages on the gradient stay O(W).  Mechanical
    einsum-by-einsum transposition, validated against `jax.linear_transpose`
    (tests/test_kernels.py).
    """
    es = lambda s, p, q: jnp.einsum(s, p, q, precision=precision)
    ua_re = es("wab,bk->wak", g, m["icb_re"])
    ua_im = -es("wab,bk->wak", g, m["icb_im"])
    k1 = es("wak,ac->wck", ua_re + ua_im, m["ifa_re"])
    t_re = k1 + es("wak,ac->wck", ua_im, m["ifa_d"])
    t_im = k1 - es("wak,ac->wck", ua_re, m["ifa_s"])
    zw_re = t_re * otf_re + t_im * otf_im
    zw_im = -t_re * otf_im + t_im * otf_re
    # LMMᵗ in the Fourier domain: Bm[m] = Σ_w tpl[m, w] · Zw[w]
    zm_re = es("wck,mw->mck", zw_re, tpl_w)
    zm_im = es("wck,mw->mck", zw_im, tpl_w)
    k1 = es("mck,ca->mak", zm_re + zm_im, m["fa_re"])
    yb_re = k1 + es("mck,ca->mak", zm_im, m["fa_d"])
    yb_im = k1 - es("mck,ca->mak", zm_re, m["fa_s"])
    return es("mak,kb->mab", yb_re, m["fb_re"]) + es("mak,kb->mab", yb_im, m["fb_im"])
