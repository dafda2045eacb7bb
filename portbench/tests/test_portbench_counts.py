"""The yardstick's arithmetic against hand-computed values: the per-block
int8 counts and the decode's model work for Cnn10 at the serving shape,
the tail over all batches, and the trace's busy time, idle share and
range times from a hand-made trace with a planted gap."""
from __future__ import annotations

import json
import types

import numpy as np
import pytest

from conftest import REPO
from portbench import common
from portbench.counts import peaks, work
from portbench.reference.params import dims

# Cnn10 at batch 512, T_mel 1024, 64 bins: (ops, bytes) a ConvBlock, counted
# by hand: 2·N·H·W·9·(Ci·Co + Co·Co); the stem's f32 mel in, int8 weights
# and 16·Co bytes of epilogue vectors, the pooled output (block 4: f32)
CNN10_BLOCKS = [(2_512_555_868_160, 134_217_728 + 38_464 + 536_870_912),
                (3_710_851_743_744, 536_870_912 + 223_232 + 268_435_456),
                (3_710_851_743_744, 268_435_456 + 888_832 + 134_217_728),
                (3_710_851_743_744, 134_217_728 + 3_547_136 + 268_435_456)]


def test_int8_per_block_counts_of_cnn10():
    bl = work.blocks("Cnn10", 512, 1024, 64)
    for i, (b, (ops, nbytes)) in enumerate(zip(bl, CNN10_BLOCKS)):
        assert b["ops"] == ops
        assert work.int8_block_bytes(b, i == 0, i == 3) == nbytes
    least = sum(max(o / 1979e12, n / 3.35e12) for o, n in CNN10_BLOCKS)
    head = work.head("Cnn10", 512, 1024, 64, 512)
    assert head["ops"] == 2.0 * 512 * 512 * 512
    assert work.int8_encoder_least_s("Cnn10", 512, 1024, 64, 512) == pytest.approx(
        least + max(head["ops"] / 67e12, head["bytes"] / 3.35e12), rel=1e-12)
    # every Cnn10 block is bound by its operations at the int8 peak
    assert all(o / 1979e12 > n / 3.35e12 for o, n in CNN10_BLOCKS)


def test_serve_mfu_count_of_cnn10():
    conf = common.load_json(REPO / "portbench/configs/acvae_cnn10.json")
    d = dims(conf)
    prior = (2 * 512 * 512 + 2 * 64 * 512 * 2 + 2 * 1536 * 2048 + 2 * 512 * 2048
             + 2 * 512 * 1024)
    dec = (2 * 512 * 512 + 2 * 64 * 512 * 2 + 2 * 1536 * 1536 + 2 * 512 * 1536
           + 2 * 512 * 4981)
    assert (prior, dec) == (10_092_544, 12_047_360)
    assert work.decode_step_ops(1536, 64, d) == 1536 * (prior + dec)
    f32 = (2.0 * 512 * 512 * 512 + 2 * 2.0 * 512 * 64 * 512 * 512
           + 20 * 1536 * (prior + dec))
    want = sum(o for o, _ in CNN10_BLOCKS) / 1979e12 + f32 / 67e12
    assert work.serve_batch_least_s(conf, d, 512, 1024, 3, 20, True) == pytest.approx(want)
    assert peaks.rate("float32", tf32_allowed=True) == 495e12
    assert peaks.rate("float32") == 67e12


def test_batch_p95_is_over_all_batches():
    ms = list(range(1, 101))
    assert common.p95(ms) == pytest.approx(95.05)
    # one stalled batch in 20 moves the tail; medians of chunks would not see it
    ms = [70.0] * 19 + [700.0]
    assert common.p95(ms) == pytest.approx(70.0 + 0.05 * 630.0)   # rank 18.05 of 0..19


def _trace(tmp_path):
    ev = [{"cat": "user_annotation", "name": "harness.window", "ts": 0, "dur": 100, "tid": 1},
          {"cat": "user_annotation", "name": "decode_loop", "ts": 20, "dur": 50, "tid": 1},
          {"cat": "user_annotation", "name": "encoder", "ts": 0, "dur": 4, "tid": 1},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1, "dur": 1, "tid": 1,
           "args": {"correlation": 7}},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 3, "dur": 1, "tid": 1,
           "args": {"correlation": 8}},
          {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 22, "dur": 1, "tid": 2,
           "args": {"correlation": 9}},
          {"cat": "kernel", "name": "a", "ts": 0, "dur": 10, "args": {"correlation": 7}},
          {"cat": "kernel", "name": "b", "ts": 5, "dur": 15, "args": {"correlation": 8}},
          {"cat": "gpu_memcpy", "name": "c", "ts": 60, "dur": 20, "args": {"correlation": 9}}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return common.Trace(p, (0.0, 100e-6), units=1)


def test_device_idle_from_a_planted_gap(tmp_path):
    tr = _trace(tmp_path)
    assert tr.busy_s() == pytest.approx(40e-6)           # [0, 20) and [60, 80)
    ctx = types.SimpleNamespace(trace=tr, units=1)
    idle = common.load_module(REPO / "portbench/metrics/device_idle.serve.py")
    assert idle.read(ctx) == pytest.approx(60.0)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert gaps["decode_loop"] == pytest.approx(40e-6)   # the planted gap
    assert gaps["outside the program's ranges"] == pytest.approx(20e-6)
    assert tr.kernel_s_in("encoder") == pytest.approx(25e-6)    # launched inside it
    assert tr.kernel_s_in("decode_loop") == 0.0       # the copy came from another thread
    assert tr.kernel_s_in("beam_topk") is None
    enc = common.load_module(REPO / "portbench/metrics/encoder_ms.serve.py")
    assert enc.read(ctx) == pytest.approx(25e-3)
    assert tr.device_ops()[0] == ["c", pytest.approx(20e-6)]


def test_train_count_is_three_forwards():
    conf = common.load_json(REPO / "portbench/configs/acvae_cnn10.json")
    d = dims(conf)
    one = work.train_step_least_s(conf, d, 128, 1024, 22)
    conv = work.encoder_conv_ops("Cnn10", 128, 1024, 64)
    assert conv == sum(o for o, _ in CNN10_BLOCKS) / 4
    assert one > 3 * conv / 989e12
    assert np.isfinite(one)
