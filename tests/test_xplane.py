"""utils/xplane.py on a synthetic XSpace laid out like a jax.profiler
trace from a GPU: one plane per card, one line per CUDA stream, one
event per kernel."""

import os

from efficientvideoclassification_youtube8m_tpu.data.proto import (
    _len_field,
    _tag,
    write_varint,
)
from efficientvideoclassification_youtube8m_tpu.utils import xplane


def _varint_field(num, value):
    return _tag(num, 0) + write_varint(value)


def _plane(name, lines, kernels):
    """XPlane{name=2, lines=3, event_metadata=4 (map<int64, meta>)}."""
    ids = {k: i + 1 for i, k in enumerate(kernels)}
    body = _len_field(2, name.encode())
    for line_name, events in lines:
        evs = b"".join(
            _len_field(4, _varint_field(1, ids[k]) + _varint_field(2, start)
                       + _varint_field(3, dur_ps))
            for k, start, dur_ps in events)
        body += _len_field(3, _len_field(2, line_name.encode()) + evs)
    for k, i in ids.items():
        meta = _varint_field(1, i) + _len_field(2, k.encode())
        body += _len_field(4, _varint_field(1, i) + _len_field(2, meta))
    return _len_field(1, body)


def _write_trace(root):
    ms = 10**9  # picoseconds per millisecond
    gpu = _plane("/device:GPU:0", [
        ("Stream #13(Compute,Memset)", [
            ("sm90_xmma_gemm_bf16", 0, 3 * ms),
            ("loop_select_tanh_fusion", 3 * ms, 1 * ms),
            ("sm90_xmma_gemm_bf16", 5 * ms, 3 * ms),
        ]),
        ("Stream #14(MemcpyH2D)", [("MemcpyH2D", 0, 2 * ms)]),
    ], ["sm90_xmma_gemm_bf16", "loop_select_tanh_fusion", "MemcpyH2D"])
    gpu1 = _plane("/device:GPU:1", [
        ("Stream #13(Compute,Memset)", [("all_reduce", 0, 8 * ms)]),
    ], ["all_reduce"])
    host = _plane("/host:CPU", [
        ("python", [("step", 0, 50 * ms)]),
    ], ["step"])
    d = os.path.join(root, "plugins", "profile", "run")
    os.makedirs(d)
    with open(os.path.join(d, "host.xplane.pb"), "wb") as f:
        f.write(gpu + gpu1 + host)


def test_parse_xplane_reads_gpu_planes(tmp_path):
    _write_trace(str(tmp_path))
    planes = xplane.parse_xplane(
        str(tmp_path / "plugins/profile/run/host.xplane.pb"))
    assert set(planes) == {"/device:GPU:0", "/device:GPU:1", "/host:CPU"}
    assert planes["/device:GPU:0"][
        "Stream #13(Compute,Memset)//sm90_xmma_gemm_bf16"] == 6 * 10**9


def test_summarize_trace_defaults_to_the_first_gpu(tmp_path):
    _write_trace(str(tmp_path))
    rows = xplane.summarize_trace(str(tmp_path), steps=2)
    # ms per step on /device:GPU:0 only; the host and GPU:1 are ignored
    assert rows == [(3.0, "sm90_xmma_gemm_bf16"), (1.0, "MemcpyH2D"),
                    (0.5, "loop_select_tanh_fusion")]
    assert xplane.summarize_trace(str(tmp_path), plane="/device:GPU:1") == [
        (8.0, "all_reduce")]
    # a line filter keeps one stream
    assert xplane.summarize_trace(str(tmp_path), line="MemcpyH2D") == [
        (2.0, "MemcpyH2D")]
