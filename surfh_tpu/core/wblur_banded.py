"""Spectral blur as a blocked *banded* contraction (plain JAX).

The spectral response wpsf[λ', λ, β] is band-limited: detector wavelength λ'
only receives flux from cube wavelengths λ in a narrow sinc²-support band
around it (reference SpectralBlur windows + margin, instru.py:499-572).  The
dense path (`core.wblur`) contracts over the whole λ-window; this one
exploits the band:

* host side, once: find each λ'-tile's band [start, start+LB) and re-base the
  wpsf into blocks [nT, LB·B, TK] (zero outside the true band);
* device side: gather each tile's [LB, B, SA] slab of the input at its
  static start (`starts[:, None] + arange(LB)`), then ONE batched einsum
  [nT, LB·B, TK] × [nT, LB·B, SA] over the tiles.

FLOP and memory-read savings vs dense ≈ W / LB (window length over band
width).  Backs the opt-in `wblur_impl="banded"`; the flagship's
`window_local` mode runs the dense GEMM.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .precision import gemm_precision


@dataclass(frozen=True)
class BandPlan:
    """Static banded-contraction plan for one channel's wpsf [K, W, B]."""

    starts: np.ndarray  # int32 [nT] λ-window offset of each λ'-tile's band
    wpsf_blocked: np.ndarray  # f32 [nT, LB·B, TK] re-based transfer blocks
    K: int  # true λ' count (output padded to nT·TK then sliced)
    W: int  # λ-window length
    B: int  # β (slit) width
    LB: int  # band length (λ samples per tile)
    TK: int  # λ' tile size

    @property
    def n_tiles(self) -> int:
        return self.starts.shape[0]

    @property
    def density(self) -> float:
        """Banded fraction of the dense contraction (lower = more saving)."""
        return self.LB / max(self.W, 1)


def _support(wpsf: np.ndarray, eps: float, rel_eps: float) -> np.ndarray:
    """[K, W] mask of the (λ', λ) pairs whose response exceeds the threshold."""
    thresh = max(eps, rel_eps * float(np.abs(wpsf).max()))
    return np.abs(wpsf).max(axis=2) > thresh


def build_band_plan(
    wpsf: np.ndarray, tile_k: int = 128, eps: float = 0.0, rel_eps: float = 0.0
) -> BandPlan:
    """Analyze the wpsf's λ-support and build the blocked banded form.

    `eps` is an absolute support threshold; `rel_eps` is relative to the
    wpsf's global maximum (the sinc² response has algebraic tails that never
    reach exact zero, so a small relative threshold — e.g. 1e-6 — is what
    actually creates a band; the truncation error is of the same order)."""
    wpsf = np.asarray(wpsf)
    K, W, B = wpsf.shape
    nT = -(-K // tile_k)
    K_pad = nT * tile_k

    support = _support(wpsf, eps, rel_eps)
    lo = np.full(K_pad, W, np.int64)
    hi = np.full(K_pad, 0, np.int64)
    any_k = support.any(axis=1)
    lo[:K][any_k] = support.argmax(axis=1)[any_k]
    hi[:K][any_k] = W - support[:, ::-1].argmax(axis=1)[any_k]

    starts = np.zeros(nT, np.int64)
    LB = 1
    for t in range(nT):
        ks = slice(t * tile_k, (t + 1) * tile_k)
        s = int(lo[ks].min()) if (lo[ks] < W).any() else 0
        e = int(hi[ks].max())
        starts[t] = min(s, max(W - 1, 0))
        LB = max(LB, e - s)
    LB = min(W, LB)
    starts = np.minimum(starts, max(W - LB, 0))

    blocked = np.zeros((nT, LB * B, tile_k), np.float32)
    for t in range(nT):
        s = int(starts[t])
        block = np.zeros((tile_k, LB, B))
        blk = wpsf[min(t * tile_k, K) : min((t + 1) * tile_k, K), s : s + LB, :]
        block[: blk.shape[0]] = blk
        blocked[t] = block.transpose(1, 2, 0).reshape(LB * B, tile_k)
    return BandPlan(starts.astype(np.int32), blocked, K, W, B, LB, tile_k)


def wblur_sum_beta_banded(windows, plan: BandPlan):
    """Banded version of `wblur.wblur_sum_beta_batched`.

    windows: [S, W, A, B] slit stacks → out [S, K, A]
    (out[s,k,a] = Σ_{l,b} windows[s,l,a,b] · wpsf[k,l,b]).
    """
    S, W, A, B = windows.shape
    if (W, B) != (plan.W, plan.B):
        raise ValueError(f"windows {windows.shape} do not match the plan")
    # slits fold into the contraction's N dimension
    arr = jnp.transpose(windows, (1, 3, 0, 2)).reshape(W, B, S * A)
    rows = plan.starts[:, None] + np.arange(plan.LB)[None, :]  # [nT, LB]
    slab = arr[rows].reshape(plan.n_tiles, plan.LB * B, S * A)
    out = jnp.einsum(
        "tmk,tms->tks", jnp.asarray(plan.wpsf_blocked, arr.dtype), slab,
        preferred_element_type=arr.dtype, precision=gemm_precision(),
    )
    out = out.reshape(plan.n_tiles * plan.TK, S, A)[: plan.K]
    return jnp.transpose(out, (1, 0, 2))


@dataclass(frozen=True)
class BandPlanT:
    """Banded plan for the adjoint direction (λ'-support per λ-tile)."""

    starts: np.ndarray  # int32 [nT] λ' offset of each λ-tile's band
    wpsf_blocked: np.ndarray  # f32 [nT, TL·B, KB]
    K: int
    W: int
    B: int
    TL: int  # λ rows per tile
    KB: int  # λ' band length

    @property
    def n_tiles(self) -> int:
        return self.starts.shape[0]


def build_band_plan_t(
    wpsf: np.ndarray, tile_l: int = 16, eps: float = 0.0, rel_eps: float = 0.0
) -> BandPlanT:
    """Blocked banded form of the transpose contraction
    out[l,b,·] = Σ_k wpsf[k,l,b]·y[k,·]."""
    wpsf = np.asarray(wpsf)
    K, W, B = wpsf.shape
    TL = tile_l
    nT = -(-W // TL)

    support = _support(wpsf, eps, rel_eps)
    lo = np.full(W, K, np.int64)
    hi = np.full(W, 0, np.int64)
    any_l = support.any(axis=0)
    lo[any_l] = support.argmax(axis=0)[any_l]
    hi[any_l] = K - support[::-1, :].argmax(axis=0)[any_l]

    starts = np.zeros(nT, np.int64)
    KB = 1
    for t in range(nT):
        ls = slice(t * TL, min((t + 1) * TL, W))
        s = int(lo[ls].min()) if (lo[ls] < K).any() else 0
        e = int(hi[ls].max())
        starts[t] = min(s, max(K - 1, 0))
        KB = max(KB, e - s)
    KB = min(K, KB)
    starts = np.clip(starts, 0, max(K - KB, 0))

    blocked = np.zeros((nT, TL * B, KB), np.float32)
    for t in range(nT):
        s = int(starts[t])
        ls = slice(t * TL, min((t + 1) * TL, W))
        blk = wpsf[s : s + KB, ls, :]  # [KB, tl, B]
        tmp = np.zeros((TL, B, KB))
        tmp[: blk.shape[1]] = blk.transpose(1, 2, 0)
        blocked[t] = tmp.reshape(TL * B, KB)
    return BandPlanT(starts.astype(np.int32), blocked, K, W, B, TL, KB)


def wblur_sum_beta_t_banded(y, plan: BandPlanT):
    """Banded transpose of `wblur_sum_beta_batched`.

    y: [S, K, A] detector blocks → out [S, W, A, B]
    (out[s,l,a,b] = Σ_k y[s,k,a]·wpsf[k,l,b])."""
    S, K, A = y.shape
    if K != plan.K:
        raise ValueError(f"y {y.shape} does not match the plan (K={plan.K})")
    y2d = jnp.transpose(y, (1, 0, 2)).reshape(K, S * A)
    rows = plan.starts[:, None] + np.arange(plan.KB)[None, :]  # [nT, KB]
    out = jnp.einsum(
        "tmk,tks->tms", jnp.asarray(plan.wpsf_blocked, y2d.dtype), y2d[rows],
        preferred_element_type=y2d.dtype, precision=gemm_precision(),
    )
    out = out.reshape(plan.n_tiles * plan.TL, plan.B, S, A)[: plan.W]
    return jnp.transpose(out, (2, 0, 3, 1))


def wblur_sum_beta_banded_reference(windows, plan: BandPlan):
    """NumPy check implementation of the banded contraction (tests)."""
    S, W, A, B = np.shape(windows)
    out = np.zeros((S, plan.n_tiles * plan.TK, A), np.float32)
    arr = np.transpose(np.asarray(windows), (1, 3, 0, 2)).reshape(W, B, S * A)
    for t in range(plan.n_tiles):
        s = int(plan.starts[t])
        x2d = arr[s : s + plan.LB].reshape(plan.LB * B, S * A)
        blk = plan.wpsf_blocked[t].T @ x2d  # [TK, S·A]
        out[:, t * plan.TK : (t + 1) * plan.TK, :] = (
            blk.reshape(plan.TK, S, A).transpose(1, 0, 2)
        )
    return out[:, : plan.K, :]
