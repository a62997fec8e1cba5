"""Configuration system.

The reference hard-codes absolute data paths and per-run parameters in
scripts (SURVEY.md §5: realmiri.py:15, global_variable_testing.py:237,
simulation_data.py:14-15) with a single click CLI on top.  Here runs are
described by dataclass configs that round-trip to JSON, with a data-root
setting resolved from (explicit value > $SURFH_DATA_ROOT > cwd).  The
per-backend algorithm choices live in one table, :func:`platform_policy`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


def data_root(explicit: Optional[str] = None) -> str:
    """Resolve the data root: explicit > $SURFH_DATA_ROOT > cwd."""
    return explicit or os.environ.get("SURFH_DATA_ROOT") or os.getcwd()


@dataclass(frozen=True)
class PlatformPolicy:
    """Algorithm choices that depend on the backend the program runs on.

    conv_impl:
        What `conv_impl="auto"` resolves to.  "matmul" is the only spatial
        conv with the λ-rank factorization and the PSF-stamp tables (no
        host-built materialized transfer function); "fft" is XLA's FFT,
        which on the CPU (pocketfft) is already fast and keeps the CPU
        tests' graphs small.
    max_unrolled_pointings:
        Channels with at most this many dither pointings unroll the
        pointing loop (constant gather tables, cross-pointing fusion);
        more pointings run as a `lax.scan`, keeping the graph O(1) in the
        pointing count (XLA-CPU compiles of the unrolled 12-band × 4-pointing
        graph take tens of minutes).
    """

    conv_impl: str
    max_unrolled_pointings: int


_PLATFORM_POLICIES = {
    "cpu": PlatformPolicy(conv_impl="fft", max_unrolled_pointings=2),
    "gpu": PlatformPolicy(conv_impl="matmul", max_unrolled_pointings=4),
}


def platform_policy(backend: Optional[str] = None) -> PlatformPolicy:
    """The :class:`PlatformPolicy` of `backend` (default: JAX's default
    backend).  A backend without an entry is an error, not a default."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    try:
        return _PLATFORM_POLICIES[backend]
    except KeyError:
        raise ValueError(
            f"no platform policy for backend {backend!r}; "
            f"known: {sorted(_PLATFORM_POLICIES)}"
        ) from None


@dataclass
class SolverConfig:
    method: str = "lcg"  # lcg | mmmg
    niter: int = 50
    mu_reg: float = 5e3
    mu_spectro: float = 1.0
    tolerance: float = 1e-12
    gradient: str = "separated"  # separated | joint
    checkpoint_every: int = 0
    value_init: float = 0.5


@dataclass
class ModelConfig:
    npix: int = 501
    step_arcsec: float = 0.025
    n_templates: int = 4
    gridding: str = "bilinear"  # bilinear | nn
    wblur_impl: str = "dense"  # dense | banded
    wblur_band_rtol: float = 0.0
    dtype: str = "float32"


@dataclass
class FusionConfig:
    """One fusion run: data location + model + solver."""

    fusion_dir: Optional[str] = None  # real-data directory (see pipeline.py)
    bands: List[str] = field(default_factory=lambda: ["1a", "2a"])
    simulated: bool = False
    scale_data: bool = False
    sharded: bool = False
    output_dir: str = "./surfh_results"
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)

    # ------------------------------------------------------------------
    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as fh:
                fh.write(s + "\n")
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "FusionConfig":
        if os.path.exists(path_or_str):
            with open(path_or_str) as fh:
                raw = json.load(fh)
        else:
            raw = json.loads(path_or_str)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "FusionConfig":
        raw = dict(raw)
        model = ModelConfig(**raw.pop("model", {}))
        solver = SolverConfig(**raw.pop("solver", {}))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(model=model, solver=solver, **raw)
