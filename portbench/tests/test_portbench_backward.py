"""The readers of the train step's backward ranges and of the collector's
range, on a planted trace: the main thread (1) holds the step's
``backward`` range, autograd's thread (2) the ``backward.*`` ranges and the
kernels they launch; a program without those ranges reads nothing."""
from __future__ import annotations

import json
import sys
import types

import pytest

from conftest import REPO
from portbench import common


def _range(name, ts, dur, tid):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _kernel(corr, launch_ts, tid, ts, dur):
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts, "dur": 1,
             "tid": tid, "args": {"correlation": corr}},
            {"cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
             "args": {"correlation": corr}}]


def _trace(tmp_path, marked=True):
    """Two units in [0, 400) us.  Kernels: forward [0, 40), then the
    backward's, launched from thread 2: the loss's [60, 70), the loop's
    [80, 120) and [140, 160), the posterior's [170, 180), the encoder's
    [190, 230) and [250, 255); then the optimizer's [290, 300).  The gaps
    that begin inside the backward ranges: 70-80 (loss), 120-140 and
    160-170 (loop), 180-190 (posterior), 230-250 (encoder); 255-290 begins
    in the main ``backward`` only.  ``python.gc`` 10-14 on thread 1, and
    395-410 on thread 2, half past the window."""
    ev = [_range("harness.window", 0, 400, 1), _range("forward", 0, 45, 1),
          _range("backward", 50, 220, 1), _range("optimizer", 280, 30, 1),
          _range("python.gc", 10, 4, 1), _range("python.gc", 395, 15, 2)]
    if marked:
        ev += [_range("backward.loss", 55, 20, 2), _range("backward.decode_loop", 75, 90, 2),
               _range("backward.posterior", 165, 20, 2),
               _range("backward.encoder", 185, 65, 2)]
    ev += _kernel(1, 1, 1, 0, 40)
    for corr, launch, ts, dur in ((2, 56, 60, 10), (3, 76, 80, 40), (4, 77, 140, 20),
                                  (5, 166, 170, 10), (6, 186, 190, 40),
                                  (8, 240, 250, 5)):
        ev += _kernel(corr, launch, 2, ts, dur)
    ev += _kernel(7, 281, 1, 290, 10)
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return common.Trace(p, (0.0, 400e-6), units=2)


def _read(metric, ctx):
    return common.load_module(REPO / "portbench" / "metrics" / f"{metric}.py").read(ctx)


def test_backward_kernels_by_region(tmp_path):
    ctx = types.SimpleNamespace(trace=_trace(tmp_path), units=2)
    assert _read("backward_decode_loop_ms.train", ctx) == pytest.approx(30e-3)
    assert _read("backward_posterior_ms.train", ctx) == pytest.approx(5e-3)
    assert _read("backward_encoder_ms.train", ctx) == pytest.approx(22.5e-3)
    loss = ctx.trace.kernel_s_in("backward.loss") / 2 * 1e3
    # the regions and the loss make up the residue of backward_ms.train
    parts = sum(_read(f"backward_{r}_ms.train", ctx)
                for r in ("decode_loop", "posterior", "encoder")) + loss
    assert parts == pytest.approx(_read("backward_ms.train", ctx))


def test_backward_gap_sums_the_marked_labels(tmp_path):
    ctx = types.SimpleNamespace(trace=_trace(tmp_path), units=2)
    # 10 + 20 + 10 + 10 + 20 us over 2 steps; 255-290 stays plain "backward"
    assert _read("backward_gap_ms.train", ctx) == pytest.approx(35e-3)
    gaps = dict(ctx.trace.idle_gaps(top=99))
    assert gaps["backward"] == pytest.approx(35e-6)


def test_no_backward_ranges_read_nothing(tmp_path):
    ctx = types.SimpleNamespace(trace=_trace(tmp_path, marked=False), units=2)
    for m in ("backward_decode_loop_ms.train", "backward_posterior_ms.train",
              "backward_encoder_ms.train", "backward_gap_ms.train"):
        assert _read(m, ctx) is None, m


def test_gc_ms_inside_the_window(tmp_path, monkeypatch):
    import acvae_tpu_torch.train.profiling  # noqa: F401  (the program's range)
    ctx = types.SimpleNamespace(trace=_trace(tmp_path), units=2)
    # 4 us + the 5 us of the second range inside the window, over 2 units
    assert _read("gc_ms.train", ctx) == pytest.approx(4.5e-3)
    assert _read("gc_ms.serve", ctx) == pytest.approx(4.5e-3)
    monkeypatch.setitem(sys.modules, "acvae_tpu_torch.train.profiling",
                        types.ModuleType("profiling_without_the_range"))
    assert _read("gc_ms.train", ctx) is None
    assert _read("gc_ms.serve", ctx) is None
