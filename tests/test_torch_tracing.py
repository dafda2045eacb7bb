"""The port's trace ranges under a CPU ``torch.profiler``: the train step's
backward split by the forward region that made it (``backward.loss``,
``backward.decode_loop``, ``backward.posterior``, ``backward.encoder``),
each garbage collection (``python.gc``) and a batch's upload (``upload``);
and none of them, nor any change to the autograd graph or the numbers,
without a profiler.  Small widths, one step each.
"""
import gc
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from acvae_tpu_torch.cli.main import _to_device
from acvae_tpu_torch.configs import flagship_conf
from acvae_tpu_torch.core.config import load_config
from acvae_tpu_torch.data.dataset import Batch
from acvae_tpu_torch.train import profiling
from acvae_tpu_torch.train.trainer import Trainer, compute_loss

V, E, N, TMEL, FDIM, L = 25, 16, 3, 64, 16, 8
FLAGSHIP = dict(
    encoder_args={"embed_size": E, "channels": (4, 8, 8, 16)},
    decoder_args={"embed_size": E, "hidden_size": E},
    model_args={"posterior_model": "PosteriorRNN_hybrid",
                "posterior_args": {"hidden_size": E},
                "prior_model": "PriorRNN", "prior_args": {"hidden_size": E}},
    augment_args={"p": 1.0, "W": 8, "T": 10, "F": 4})
MARK = "autograd::engine::evaluate_function: _MarkBackward"
EVALUATE = "autograd::engine::evaluate_function: "


def _conf(recipe):
    """The flagship at the trainer tests' widths, or ``configs/<recipe>.yaml``
    at test size."""
    if recipe == "ac_vae":
        return flagship_conf(**FLAGSHIP)
    conf = json.loads(json.dumps(load_config(f"configs/{recipe}.yaml")))
    conf["encoder_args"] = {"embed_size": E, "channels": [4, 8, 8, 16]}
    dec = dict(conf["decoder_args"], embed_size=E, hidden_size=E)
    if "nhead" in dec:
        dec.update(nhead=2, hidden_size=32)
    conf["decoder_args"] = dec
    for key in ("posterior_args", "prior_args"):
        if key in conf.get("model_args", {}):
            conf["model_args"][key] = dict(conf["model_args"][key], hidden_size=E)
    conf.update(augments=None)
    return conf


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(3, V, size=(N, L)).astype(np.int32)
    caps[:, 0] = 1
    return {"feats": rng.normal(size=(N, TMEL, FDIM)).astype(np.float32),
            "feat_lens": np.array([TMEL, 48, 33], np.int32),
            "caps": caps, "cap_lens": np.array([L, 5, 3], np.int32)}


def _profiled(fn, tmp_path):
    """Run ``fn`` under a CPU profiler; its Chrome trace's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _ranges(events, name):
    return [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] == name]


@pytest.mark.parametrize("recipe", ["ac_vae", "trans_vae", "attn_rnn_xe"])
def test_backward_ranges_follow_the_forward_regions(recipe, tmp_path):
    """One profiled ``Trainer.step``: each ``backward.*`` range once,
    disjoint, in the reverse of the forward's order and inside the main
    ``backward`` range; and every backward node that a forward op made
    (matched by the profiler's sequence number) runs inside the range
    named after the forward region of that op (ops outside ``encoder``,
    ``posterior`` and ``decode_loop`` are the loss's).  The only nodes left
    over are the marks, whose node opens the next range."""
    regions = ["encoder", "posterior", "decode_loop"]
    if recipe == "attn_rnn_xe":
        regions.remove("posterior")
    torch.manual_seed(0)
    trainer = Trainer(_conf(recipe), V, FDIM, device="cpu", total_iters=10)
    events = _profiled(lambda: trainer.step(_batch(), 1, 12), tmp_path)

    fwd = {r: _ranges(events, r) for r in ["forward"] + regions}
    bwd = {r: _ranges(events, "backward." + r) for r in ["loss"] + regions[::-1]}
    assert all(len(v) == 1 for v in fwd.values()), fwd
    assert all(len(v) == 1 for v in bwd.values()), bwd
    (main,) = _ranges(events, "backward")
    order = [bwd[r][0] for r in ["loss"] + regions[::-1]]
    assert main[0] <= order[0][0] and order[-1][1] <= main[1]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))

    f0, f1, _ = fwd["forward"][0]
    region_of = {}
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: e["ts"])
    for e in ops:
        seq = e["args"].get("Sequence number")
        if seq is None or not f0 <= e["ts"] < f1:
            continue
        # the last op to read a sequence number is the one that made its node
        region_of[seq] = next((r for r in regions if fwd[r][0][0] <= e["ts"]
                               < fwd[r][0][1]), "loss")
    inside, left = 0, []
    for e in ops:
        seq = e["args"].get("Sequence number")
        if not e["name"].startswith(EVALUATE) or seq not in region_of:
            continue
        a, b, _ = bwd[region_of[seq]][0]
        if a <= e["ts"] and e["ts"] + e["dur"] <= b:
            inside += 1
        else:
            left.append((e["name"], region_of[seq]))
    assert inside >= 0.99 * (inside + len(left)), left
    assert sorted(left) == sorted((MARK, r) for r in ["loss"] + regions), left


def _step(trainer, seed):
    torch.manual_seed(seed)      # the dropouts
    m = trainer.step(_batch(), 1, 12)
    return ({k: v.clone() for k, v in m.items()},
            {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None},
            {k: v.clone() for k, v in trainer.model.state_dict().items()})


def test_profiled_step_is_bit_identical(tmp_path):
    """The marks change no number: losses, gradients, parameters and
    buffers of a step under the profiler equal those without it, bit for
    bit (dropouts on)."""
    conf = flagship_conf(**FLAGSHIP)
    plain = _step(Trainer(conf, V, FDIM, device="cpu", total_iters=10), 7)
    traced = Trainer(conf, V, FDIM, device="cpu", total_iters=10)
    got = []
    events = _profiled(lambda: got.append(_step(traced, 7)), tmp_path)
    assert _ranges(events, "backward.encoder")
    for a, b in zip(plain, got[0]):
        assert a.keys() == b.keys() and a
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _nodes(loss):
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return [fn.name() for fn in seen]


def test_no_mark_without_a_profiler(tmp_path):
    """Without a profiler the loss's graph holds no mark node; under one,
    a mark for each of the four regions."""
    trainer = Trainer(flagship_conf(**FLAGSHIP), V, FDIM, device="cpu",
                      total_iters=10)
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    loss = lambda: compute_loss(trainer.model, batch, 1.0, 0.0, 0.5,  # noqa: E731
                                None)[0]
    assert "_MarkBackward" not in _nodes(loss())
    got = []
    _profiled(lambda: got.append(_nodes(loss())), tmp_path)
    assert got[0].count("_MarkBackward") == 4


def test_gc_range_only_under_a_profiler(tmp_path, monkeypatch):
    """``gc.collect()`` under a profiler is one ``python.gc`` range; without
    one the hook opens no range."""
    opened = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name) or real(name))
    was = gc.isenabled()
    gc.disable()          # no collection but the one asked for
    try:
        gc.collect()
        assert opened == []
        events = _profiled(gc.collect, tmp_path)
    finally:
        if was:
            gc.enable()
    assert len(_ranges(events, profiling.GC_RANGE)) == 1
    assert opened == [profiling.GC_RANGE]


def test_upload_range_in_the_cli_trace(tmp_path):
    """The loader's stage hook, run in a thread of its own as the loader's
    producer runs it, is an ``upload`` range of the CLI's ``Trace``, and
    moves the same values."""
    b = Batch(**_batch(), audio_ids=["a", "b", "c"], cap_indices=np.zeros(N),
              cap_ids=["a_0", "b_0", "c_0"])
    out = []
    t = profiling.Trace(str(tmp_path))
    worker = threading.Thread(target=lambda: out.append(
        _to_device(b, torch.device("cpu"))))
    worker.start()
    worker.join()
    with record_function("main"):
        pass
    path = t.stop()
    events = json.loads(open(path).read())["traceEvents"]
    (upload,), (main,) = _ranges(events, "upload"), _ranges(events, "main")
    assert upload[2] != main[2]
    for k in ("feats", "feat_lens", "caps", "cap_lens"):
        assert np.array_equal(getattr(out[0], k).numpy(), getattr(b, k))
