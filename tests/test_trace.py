"""bench_trace.py's reduction from a GPU profiler trace to pipeline stages,
on a small synthetic trace shaped like the ones the H100 writes (kernels
named after their HLO instructions, launched inside CUDA graphs)."""

import gzip
import json

import pytest

import bench_trace as BT

SCOPES_HLO = """
  %loop_select_fusion.1 = s32[8]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(f)/bin_sort/emit/select_n" stack_frame_id=1}
  %sort.45.0 = (s32[4,8]{1,0}) sort(%a), dimensions={1}, metadata={op_name="jit(f)/bin_sort/compact/sort" scheduling_name="sort.45.0"}
  %fusion.7 = f32[8]{0} fusion(%q), kind=kLoop, metadata={op_name="jit(f)/project/mul"}
"""


def _trace(tmp_path, events):
    meta = [{"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "/device:GPU:0 NVIDIA H100"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "/host:CPU"}}]
    path = tmp_path / "t.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": meta + events}, f)
    return str(path)


def _kernel(name, ts, dur, pid=1):
    return {"ph": "X", "pid": pid, "tid": 7, "name": name, "ts": ts,
            "dur": dur, "args": {"hlo_op": "command_buffer"}}


def test_trace_stage_attribution(tmp_path):
    scopes = BT.scope_map_from_text(SCOPES_HLO)
    path = _trace(tmp_path, [
        _kernel("loop_select_fusion_1", 0, 1000),
        _kernel("sort_45_0", 1000, 3000),
        _kernel("tail_fwd", 4000, 2000),
        _kernel("tail_fwd__1", 6000, 1000),
        _kernel("fusion_7", 7000, 500),
        _kernel("mystery_kernel", 9500, 500),
        _kernel("host_work", 0, 99000, pid=2),        # not device time
    ])
    ms, _, _, idle = BT.attribute(path, scopes, reps=1)
    assert ms["emit"] == pytest.approx(1.0)
    assert ms["compact"] == pytest.approx(3.0)
    assert ms["tail_main"] == pytest.approx(3.0)
    assert ms["project"] == pytest.approx(0.5)
    assert ms["other"] == pytest.approx(0.5)
    # busy 8 ms of a 10 ms window
    assert idle == pytest.approx(0.2)


def test_trace_needs_a_gpu_process(tmp_path):
    path = tmp_path / "cpu.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": [_kernel("k", 0, 1, pid=2)]}, f)
    with pytest.raises(SystemExit, match="no /device:GPU"):
        BT.attribute(str(path), {}, reps=1)


def test_peaks_known_and_unknown():
    assert BT.peaks_for("NVIDIA H100 80GB HBM3")["hbm_gbps"] == 3350.0
    with pytest.raises(SystemExit, match="no published peaks"):
        BT.peaks_for("Some Other Card")
