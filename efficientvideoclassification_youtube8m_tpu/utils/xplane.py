"""XPlane (jax.profiler trace) parser + op-time summarizer.

`jax.profiler.start_trace` writes `*.xplane.pb` files; this parses the
XSpace proto directly with the framework's own wire codec
(data/proto.py) — no TensorFlow or profiler plugin — and aggregates
device kernel durations.

XSpace wire layout (tensorflow/core/profiler/protobuf/xplane.proto):
  XSpace  { repeated XPlane planes = 1; }
  XPlane  { int64 id=1; string name=2; repeated XLine lines=3;
            map<int64, XEventMetadata> event_metadata=4; }
  XLine   { int64 id=1; string name=2; repeated XEvent events=4; }
  XEvent  { int64 metadata_id=1; int64 offset_ps=2; int64 duration_ps=3; }
  XEventMetadata { int64 id=1; string name=2; }
"""

from __future__ import annotations

import collections
import glob as globlib
from typing import Dict, List, Optional, Tuple

from efficientvideoclassification_youtube8m_tpu.data.proto import iter_fields


def _parse_event(ebuf) -> Tuple[Optional[int], int]:
    mid, dur = None, 0
    for fn, wt, v in iter_fields(ebuf):
        if fn == 1 and wt == 0:
            mid = v
        elif fn == 3 and wt == 0:
            dur = v
    return mid, dur


def parse_xplane(path: str) -> Dict[str, Dict[str, int]]:
    """{plane_name: {"<line>//<op>": total_duration_ps}}."""
    buf = open(path, "rb").read()
    out: Dict[str, Dict[str, int]] = {}
    for fn, wt, v in iter_fields(buf):
        if fn != 1:
            continue
        pname, lines, evmeta = None, [], {}
        for fn2, wt2, v2 in iter_fields(bytes(v)):
            if fn2 == 2 and wt2 == 2:
                pname = bytes(v2).decode("utf-8", "replace")
            elif fn2 == 3 and wt2 == 2:
                lines.append(bytes(v2))
            elif fn2 == 4 and wt2 == 2:
                k, meta = None, None
                for efn, _, ev in iter_fields(bytes(v2)):
                    if efn == 1:
                        k = ev
                    elif efn == 2:
                        meta = bytes(ev)
                if meta is not None:
                    for mfn, mwt, mv in iter_fields(meta):
                        if mfn == 2 and mwt == 2:
                            evmeta[k] = bytes(mv).decode("utf-8", "replace")
        if pname is None:
            continue
        agg: Dict[str, int] = collections.Counter()
        for lb in lines:
            lname = None
            for fn3, wt3, v3 in iter_fields(lb):
                if fn3 == 2 and wt3 == 2:
                    lname = bytes(v3).decode("utf-8", "replace")
                elif fn3 == 4 and wt3 == 2:
                    mid, dur = _parse_event(bytes(v3))
                    agg[f"{lname}//{evmeta.get(mid, mid)}"] += dur
        out[pname] = dict(agg)
    return out


def summarize_trace(
    trace_dir: str,
    plane: str = "/device:GPU:0",
    line: str = "Stream #",
    top: int = 25,
    steps: int = 1,
) -> List[Tuple[float, str]]:
    """Top kernels by total duration (ms per step) on a device plane.

    A GPU trace from `jax.profiler` holds one plane per card
    ("/device:GPU:0", ...) whose lines are CUDA streams
    ("Stream #13(Compute,Memset)"); each event is one kernel, named after
    its XLA fusion or its library kernel (cuBLAS GEMMs). `plane` and
    `line` are substrings of those names."""
    files = sorted(globlib.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    if not files:
        raise IOError(f"no xplane.pb under {trace_dir}")
    agg: Dict[str, int] = collections.Counter()
    for f in files:
        planes = parse_xplane(f)
        for pname, ops in planes.items():
            if plane not in pname:
                continue
            for key, dur in ops.items():
                lname, op = key.split("//", 1)
                if line in (lname or ""):
                    agg[op] += dur
    rows = [(dur / 1e9 / steps, op) for op, dur in agg.items()]
    rows.sort(reverse=True)
    return rows[:top]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser("Summarize a jax.profiler trace")
    ap.add_argument("trace_dir")
    ap.add_argument("--plane", default="/device:GPU:0")
    ap.add_argument("--line", default="Stream #")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args(argv)
    for ms, op in summarize_trace(args.trace_dir, args.plane, args.line,
                                  args.top, args.steps):
        print(f"{ms:9.3f} ms  {op[:110]}")


if __name__ == "__main__":
    main()
