"""Trace-based per-stage attribution of the headline bench frame.

Standalone stage timings mislead (fusion and dispatch make stages
inseparable); the trustworthy attribution is MARGINAL device time inside
the real compiled frame. This captures one `jax.profiler` trace of the
exact bench workload (shared `bench.bench_setup()`), maps every GPU-side
op back to its pipeline stage through the compiled HLO's `op_name`
metadata (the `jax.named_scope` markers in render/pipeline.py and
render/tiles.py), and writes build/trace_stages.json: per-stage device ms
that SUM to the traced device total, per-stage HBM bytes (where the
profiler reports `bytes_accessed`), and the implied bandwidth as a share
of the card's peak from the PEAKS table.

Usage:  python bench_trace.py           (needs a GPU; env knobs as bench.py)
Output: build/trace_stages.json + a human table on stderr.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys

# Published peaks by JAX device_kind (NVIDIA H100 SXM data sheet, dense,
# at the 700 W power limit). A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_gbps=3350.0, bf16_tflops=989.0,
                                  f32_tflops=67.0),
}


def peaks_for(kind: str) -> dict:
    """Published peaks of a JAX device_kind; an unknown device is an
    error, never a default."""
    if kind not in PEAKS:
        raise SystemExit(f"no published peaks for {kind!r}; add them to "
                         f"PEAKS with their source")
    return PEAKS[kind]


def capture(render, params, reps: int = 6) -> str:
    import jax
    import jax.numpy as jnp

    t = jnp.asarray(0.0)
    jax.block_until_ready(render(params, t))       # compile + warm
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "trace")
    with jax.profiler.trace(trace_dir, create_perfetto_trace=True):
        for _ in range(reps):
            jax.block_until_ready(render(params, t))
    runs = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*")))
    files = glob.glob(os.path.join(runs[-1], "*.trace.json.gz"))
    return files[0]


# The Pallas kernels by the name their pallas_call gives them: a GPU
# trace shows kernels by name, and a custom call's instruction name is not
# that name.
KERNEL_STAGES = {"composite_fwd": "pass1_kernel",
                 "composite_bwd": "pass1_kernel",
                 "tail_fwd": "tail_main", "tail_bwd": "tail_main"}


def hlo_scope_map(render, params, dump: str | None = None) -> dict:
    """instruction name -> named_scope path, from compiled HLO metadata
    (the compiled HLO text is written to `dump` when given)."""
    import jax.numpy as jnp
    txt = render.lower(params, jnp.asarray(0.0)).compile().as_text()
    if dump:
        with open(dump, "w") as f:
            f.write(txt)
    return scope_map_from_text(txt)


def scope_map_from_text(txt: str) -> dict:
    """instruction name -> named_scope path from compiled HLO text."""
    scope = {}
    # metadata={op_name="jit(<lambda>)/bin_sort/global_sort/sort" ...}
    for m in re.finditer(
            r'%?([\w.\-]+)\s*=[^\n]*?metadata=\{[^}]*?op_name="([^"]+)"',
            txt):
        scope[m.group(1)] = m.group(2)
    return scope


STAGES = [
    # (label, regex over the op_name scope path) — first match wins.
    ("project", r"/project/"),
    ("emit", r"/emit(_big)?/"),
    ("depth_prune", r"/depth_prune/"),
    ("compact", r"/compact/"),
    ("global_sort", r"/global_sort/"),
    ("csr", r"/csr/"),
    ("bin_sort_other", r"/bin_sort/"),
    ("pass1_pack", r"/pass1_pack/"),
    ("pass1_kernel", r"/pass1_kernel/"),
    ("deepen_select", r"/deepen_\d+_select/"),
    ("deepen_pack", r"/deepen_\d+_pack/"),
    ("deepen_kernel", r"/deepen_\d+_kernel/"),
    ("head_exhaust", r"/head_exhaust/"),
    ("tail_main", r"/tail_main/"),
    ("tail_big", r"/tail_big/"),
    ("tail_combine", r"/tail_combine/"),
    ("tail_prep", r"/tail/"),
    ("composite_other", r"/composite/"),
]


def classify(path: str) -> str:
    for label, pat in STAGES:
        if re.search(pat, path):
            return label
    return "other"


def attribute(trace_file: str, scopes: dict, reps: int):
    with gzip.open(trace_file) as f:
        tr = json.load(f)
    ev = tr["traceEvents"]
    # Device pids: the processes named /device:GPU:*; every complete event
    # on them is device work (kernels, copies).
    dev_pids = {e["pid"] for e in ev
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "/device:GPU" in str(e.get("args", {}).get("name", ""))}
    if not dev_pids:
        raise SystemExit(f"no /device:GPU process in {trace_file}")

    # A sample of the device events as the profiler wrote them, for reading
    # by hand when the naming changes.
    sample = [e for e in ev if e.get("ph") == "X"
              and e.get("pid") in dev_pids][:60]
    with open(os.path.join(os.path.dirname(trace_file),
                           "device_events_sample.json"), "w") as f:
        json.dump(sample, f, indent=1)

    ms = collections.Counter()
    gb = collections.Counter()
    op_ms = collections.defaultdict(collections.Counter)
    spans = []
    for e in ev:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        name = e["name"]
        # The HLO instruction a kernel came from: the event's hlo_op
        # argument (unless the kernel ran inside a command buffer, a CUDA
        # graph), else its kernel name, whose "_N_M" suffix is the
        # instruction's ".N.M". Pallas kernels go by their call's name
        # ("tail_fwd", a second instance "tail_fwd__1").
        hlo = str(e.get("args", {}).get("hlo_op", name))
        label = KERNEL_STAGES.get(re.sub(r"__\d+$", "", name))
        if label is None:
            path = ""
            dotted = re.sub(r"((?:_\d+)+)$",
                            lambda m: m.group(1).replace("_", "."), name)
            for cand in (hlo, name, dotted):
                path = scopes.get(cand) or scopes.get(cand.split(".")[0], "")
                if path:
                    break
            label = classify(path)
        d_ms = e["dur"] / 1e3 / reps
        ms[label] += d_ms
        op_ms[label][name] += d_ms
        gb[label] += int(e.get("args", {}).get("bytes_accessed", 0)) / 1e9 / reps
    return ms, gb, op_ms, idle_share(spans)


def idle_share(spans) -> float:
    """1 - (union of device-busy intervals) / (first start to last end)."""
    spans = sorted(spans)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return 1.0 - busy / window if window > 0 else 0.0


def main() -> int:
    from bench import bench_setup, require_gpu
    from fourdgs.utils.cache import enable_compile_cache

    enable_compile_cache()
    device = require_gpu()
    peak_gbps = peaks_for(device["kind"])["hbm_gbps"]
    render, params, env = bench_setup()
    reps = 6
    trace_file = capture(render, params, reps)
    scopes = hlo_scope_map(render, params, dump=os.path.join(
        os.path.dirname(trace_file), "frame_hlo.txt"))
    with open(os.path.join(os.path.dirname(trace_file),
                           "scope_map_sample.json"), "w") as f:
        json.dump(dict(list(scopes.items())[:200]), f, indent=1)
    ms, gb, op_ms, idle = attribute(trace_file, scopes, reps)

    total = sum(ms.values())
    rows = []
    for label in [s[0] for s in STAGES] + ["other"]:
        if ms[label] == 0:
            continue
        bw = gb[label] / (ms[label] / 1e3) if ms[label] else 0.0
        top = op_ms[label].most_common(3)
        rows.append(dict(stage=label, ms=ms[label],
                         pct=100 * ms[label] / total,
                         hbm_gb=gb[label],
                         gbps=bw,
                         hbm_frac_of_peak=bw / peak_gbps,
                         top_ops=[f"{n} {v:.2f}ms" for n, v in top]))
    rows.sort(key=lambda r: -r["ms"])
    out = {
        "source": "jax.profiler device trace of the exact bench frame "
                  "(bench.bench_setup); per-op device duration averaged "
                  f"over {reps} frames and mapped to pipeline stages via "
                  "compiled-HLO op_name metadata (named_scope markers). "
                  "These are MARGINAL in-frame times: they sum to the "
                  "device total below.",
        "device": device,
        "config": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in env.items()},
        "device_total_ms": total,
        "device_idle_share": idle,
        "stages": rows,
    }
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "trace_stages.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"device total {total:.1f} ms over {len(rows)} stages, idle "
          f"share {idle:.3f}", file=sys.stderr)
    for r in rows:
        print(f"  {r['stage']:<18} {r['ms']:>8.2f} ms  {r['pct']:>5.1f}%  "
              f"{r['gbps']:>7.1f} GB/s", file=sys.stderr)
    print(json.dumps({"metric": "traced device ms per frame",
                      "value": total, "unit": "ms", "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
