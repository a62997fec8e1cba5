"""Unit-pin bench.py's trace reduction and its device guards.

The device time per application comes from a profiler trace: the union of
the event intervals on the `/device:GPU:N` planes.  The fabricated trace
below has the layout of an H100 trace of the flagship programs: one
`/device:GPU:0` plane whose stream line "Stream #13(Memset,Compute)" holds
one event per kernel (XLA runs them as CUDA graphs, and neighbouring events
can overlap), and host planes whose events must not count.
"""

import os
import sys

import pytest
from jax.profiler import ProfileData

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench

# times in the text proto are picoseconds from the line's timestamp (ns)
_GPU_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 13
    name: "Stream #13(Memset,Compute)"
    timestamp_ns: 1000000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000000 }
    events { metadata_id: 2 offset_ps: 3000000000 duration_ps: 3000000000 }
    events { metadata_id: 3 offset_ps: 8000000000 duration_ps: 2000000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "wrapped_concatenate" } }
  event_metadata { key: 2 value { id: 2 name: "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n" } }
  event_metadata { key: 3 value { id: 3 name: "loop_transpose_fusion_30" } }
}
planes {
  id: 2
  name: "/host:CPU"
  lines {
    id: 1
    name: "python"
    timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 50000000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "$stages.py:883 __call__" } }
}
"""


class _FakeProfiler:
    """Writes the fabricated trace where jax.profiler would write one."""

    ProfileData = ProfileData

    def __init__(self, text):
        self.text = text

    def start_trace(self, tdir):
        self.dir = tdir

    def stop_trace(self):
        if self.text is None:
            return
        d = os.path.join(self.dir, "plugins", "profile", "run1")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "host.xplane.pb"), "wb") as fh:
            fh.write(ProfileData.text_proto_to_serialized_xspace(self.text))


class _FakeJax:
    def __init__(self, text):
        self.profiler = _FakeProfiler(text)


def test_trace_parser_sums_ops_lane_only(tmp_path):
    out = bench.trace_device_ms(_FakeJax(_GPU_TRACE), lambda: None, 2,
                                str(tmp_path / "trace"))
    # kernels at [0,4), [3,6), [8,10) ms: union 8 ms over 2 apps -> 4 ms/app
    # (NOT 4.5 from summing overlapping events, NOT 25 with the host event)
    assert out["device_ms_per_app"] == pytest.approx(4.0)
    assert out["device_busy_frac"] == pytest.approx(0.8)  # 8 of a 10 ms window
    assert out["trace_events"] == 3


def test_trace_parser_handles_missing_trace(tmp_path):
    # a failed trace is an error, not a silently missing number
    with pytest.raises(RuntimeError, match="no xplane trace"):
        bench.trace_device_ms(_FakeJax(None), lambda: None, 1,
                              str(tmp_path / "trace"))
    host_only = _GPU_TRACE[_GPU_TRACE.index("planes {\n  id: 2"):]
    with pytest.raises(RuntimeError, match="no GPU events"):
        bench.device_busy(ProfileData.from_text_proto(host_only))


def test_peaks_table_resolves_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["f32_flops"] == 67e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in peaks["source"]


def test_peaks_table_rejects_unknown_device():
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_bench_refuses_cpu(capsys):
    assert bench.main() == 2
    assert capsys.readouterr().out == ""  # no result line


def test_dot_flops_counts_gemms_from_shapes():
    """GEMM FLOPs come from the jaxpr: XLA's GPU cost analysis misses the
    cuBLAS custom calls.  A scan body counts `length` times, a cond its
    costliest branch, nested jits once."""
    import jax
    import jax.numpy as jnp

    def f(a, b, pick):
        c = jax.jit(lambda u, v: u @ v)(a, b)  # 2·4·6·5
        _, ys = jax.lax.scan(lambda k, x: (k, x @ b), 0.0,
                             jnp.ones((3, 4, 5)))  # 3 × 2·4·6·5
        d = jax.lax.cond(
            pick,
            lambda: jnp.einsum("bij,bjk->bik", ys, ys.transpose(0, 2, 1)),
            lambda: jnp.zeros((3, 4, 4)),
        )  # 3 · 2·4·4·6
        return c.sum() + d.sum()

    jaxpr = jax.make_jaxpr(f)(jnp.ones((4, 5)), jnp.ones((5, 6)), True)
    assert bench.dot_flops(jaxpr) == 2 * 4 * 6 * 5 * (1 + 3) + 3 * 2 * 4 * 4 * 6
