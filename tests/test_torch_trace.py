"""The op-level stage trace of scripts/ (diag_trace_stage_torch.py,
prof_ops_torch.py) on the CPU, and the mains of the four multi-device and
trace scripts in a process where importing jax or object_slam_tpu raises.

The reference's output is an XLA-op listing of a TPU trace, which no
port run can reproduce, so the port is held by structure:
- prof_ops_torch.top_ops on hand-written chrome traces: each kernel's
  summed milliseconds and launches exact, the rows in the order of their
  time, the newest file read, the CPU ops ranked when there is no kernel
  event, and the reference's exit without a trace file;
- diag_trace_stage_torch on the small street (street.py's 416x128
  geometry, its first DRIVE frames written as a KITTI directory) for each
  --stage: rows that parse and are not empty, and the same rows when
  prof_ops_torch reads back the trace the script wrote."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))

import diag_trace_stage_torch as trace_stage  # noqa: E402
import object_slam_tpu_torch.config as tconfig  # noqa: E402
import prof_ops_torch  # noqa: E402
import street  # noqa: E402

DRIVE = 4


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def _ev(name, cat, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "dur": dur, "ts": 0,
            "pid": 0, "tid": 0}


def test_top_ops_sums_kernels(tmp_path):
    events = [_ev("gemm", "kernel", 1500.0), _ev("gemm", "kernel", 500.0),
              _ev("reduce", "kernel", 2500.0),
              _ev("copy", "kernel", 250.0), _ev("copy", "kernel", 250.0),
              _ev("copy", "kernel", 250.0),
              _ev("aten::mm", "cpu_op", 9000.0),
              _ev("cudaLaunchKernel", "cuda_runtime", 8000.0),
              _ev("gemm", "kernel", 7000.0, ph="i")]
    _write_trace(tmp_path / "host_1.1.pt.trace.json", events)
    rows = prof_ops_torch.top_ops(str(tmp_path), 30)
    assert rows == [(2.5, 1, "reduce"), (2.0, 2, "gemm"), (0.75, 3, "copy")]
    assert prof_ops_torch.top_ops(str(tmp_path), 2) == rows[:2]
    lines = []
    prof_ops_torch.print_rows(rows, lines.append)
    assert lines[0] == f"{2.5:9.2f}ms x{1:7d}  reduce"


def test_top_ops_reads_the_newest_trace_and_ranks_cpu_ops(tmp_path):
    old = tmp_path / "a" / "host_1.1.pt.trace.json"
    old.parent.mkdir()
    _write_trace(old, [_ev("gemm", "kernel", 1000.0)])
    new = tmp_path / "host_2.2.pt.trace.json"
    _write_trace(new, [_ev("aten::add", "cpu_op", 300.0),
                       _ev("aten::mm", "cpu_op", 1200.0),
                       _ev("aten::add", "cpu_op", 400.0),
                       _ev("ProfilerStep", "user_annotation", 5000.0)])
    os.utime(old, (1, 1))
    assert prof_ops_torch.newest_trace(str(tmp_path)) == str(new)
    assert prof_ops_torch.top_ops(str(tmp_path)) == [
        (1.2, 1, "aten::mm"), (0.7, 2, "aten::add")]


def test_top_ops_without_a_trace_exits(tmp_path):
    with pytest.raises(SystemExit, match="no \\*.pt.trace.json under"):
        prof_ops_torch.top_ops(str(tmp_path))


@pytest.fixture(scope="module")
def street_seq(tmp_path_factory):
    """The small street's first DRIVE pairs as a KITTI directory, written
    by the port from its renders."""
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.datasets.synthetic import render_street
    cfg = street.stereo_cfg(tconfig)
    poses, frames, _ = render_street(cfg, 12, last=DRIVE, workers=2)
    out = str(tmp_path_factory.mktemp("trace_street"))
    kitti.write_sequence(out, poses, frames)
    return cfg, out


@pytest.fixture(scope="module")
def driven(street_seq):
    cfg, seq = street_seq
    state = trace_stage.drive_state(cfg, seq, DRIVE, "cpu")
    yield cfg, state
    state["sys"].shutdown()


@pytest.mark.parametrize("stage", sorted(trace_stage.STAGE_CALLS))
def test_trace_stage_rows(driven, stage, tmp_path):
    cfg, state = driven
    args = trace_stage.parse_args(["--stage", stage, "--trace-dir",
                                   str(tmp_path / "trace"), "--top", "10",
                                   "--device", "cpu"])
    lines = []
    res = trace_stage.run(cfg, args, state=state, log=lines.append)
    rows = res["rows"]
    assert 0 < len(rows) <= 10 and len(lines) == len(rows)
    assert res["wall_ms"] > 0
    for (ms, n, name), line in zip(rows, lines):
        assert ms >= 0 and n >= 1 and name
        assert line == f"{ms:9.2f}ms x{n:7d}  {name[:110]}"
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    # the trace the script wrote, read back
    path = prof_ops_torch.newest_trace(args.trace_dir)
    assert path.endswith(".pt.trace.json")
    assert prof_ops_torch.top_ops(args.trace_dir, 10) == rows
    events = prof_ops_torch.load_events(path)
    assert not any(e.get("cat") == "kernel" for e in events)


def test_mains_run_without_the_reference(tmp_path, street_seq):
    """ab_async_device_torch and diag_async_split_torch (2 frames of a
    short arc at --scale 4), bench_ba_scaling_torch
    (a small problem over 1 and 2 gloo CPU ranks), diag_trace_stage_torch
    (--stage build on 2 street pairs) and prof_ops_torch (on the trace it
    wrote) through their mains, on the CPU, in a process where importing
    jax or object_slam_tpu raises."""
    seq = tmp_path / "seq2"
    shutil.copytree(street_seq[1], seq)
    times = open(seq / "times.txt").read().split()
    (seq / "times.txt").write_text("\n".join(times[:2]) + "\n")
    trace_dir = tmp_path / "trace"
    env = dict(os.environ, OMP_NUM_THREADS=str(share_cores()))
    code = textwrap.dedent(f"""
        import builtins, json, runpy, sys
        real = builtins.__import__

        def guard(name, *a, **kw):
            if name == "jax" or name.startswith("jax.") or \\
                    name == "object_slam_tpu" or \\
                    name.startswith("object_slam_tpu."):
                raise ImportError("the reference is not importable: " + name)
            return real(name, *a, **kw)
        builtins.__import__ = guard
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "scripts")!r},
                        {os.path.join(ROOT, "tests", "torch_fixtures")!r}]
        import object_slam_tpu_torch.config as config
        import street
        stereo = street.stereo_cfg(config)
        config.SlamConfig.kitti_stereo = staticmethod(lambda: stereo)
        import ab_async_device_torch, bench_ba_scaling_torch
        import diag_async_split_torch, diag_trace_stage_torch
        res = {{}}
        ab = ab_async_device_torch.main(["--frames", "2", "--turns", "0.02",
                                         "--scale", "4", "--device", "cpu"])
        res["ab"] = [ab["n_devices"], ab["sync"]["tracked"],
                     ab["async_dev1"]["mapping_placement"]]
        split, record = diag_async_split_torch.main(
            ["--depth", "2", "--turns", "0.02", "--scale", "4",
             "--repeats", "1", "--device", "cpu"])
        res["split"] = [[s["mapping_placement"], s["parts_from_first_run_at"]]
                        for s in split] + [record["reference"]]
        res["scaling"] = [line["devices"] for line in
                          bench_ba_scaling_torch.main(
                              ["--kf", "4", "--pts", "64", "--iters", "1",
                               "--reps", "1", "--cpu-mesh", "2"])]
        res["trace"] = len(diag_trace_stage_torch.main(
            ["--seq", {str(seq)!r}, "--stage", "build", "--frames", "2",
             "--trace-dir", {str(trace_dir)!r}, "--top", "5",
             "--device", "cpu"])["rows"])
        sys.argv = ["prof_ops_torch.py", {str(trace_dir)!r}, "3"]
        print("PROF_OPS")
        runpy.run_path({os.path.join(ROOT, "scripts", "prof_ops_torch.py")!r},
                       run_name="__main__")
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "object_slam_tpu."))
                  or m == "object_slam_tpu"]
        print("RESULT " + json.dumps(dict(res, loaded=loaded)))
    """)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["loaded"] == []
    assert res["ab"] == [1, 2, "cpu thread"]
    assert res["split"] == [["cpu thread", None], ["cpu (copied)", None],
                            None]
    assert res["scaling"] == [1, 2]
    assert res["trace"] == 5
    out = proc.stdout
    assert out.count('"mapping_placement"') == 4      # ab's 2, split's 2
    assert out.startswith("sync {") and "\nasync_dev1 {" in out
    assert out.count('"scaling_efficiency"') == 2
    prof = out.split("PROF_OPS\n", 1)[1].splitlines()[:3]
    for p in prof:
        ms, rest = p.split("ms x", 1)
        float(ms)
        assert int(rest.split()[0]) >= 1
