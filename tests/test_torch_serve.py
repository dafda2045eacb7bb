"""Port parity: the serving path of ``acvae_tpu_torch`` (vocabulary,
log-mel frontend, experiment dir, ``CaptionService``, HTTP server) against
``acvae_tpu``.

The end-to-end case writes one JAX experiment with
``acvae_tpu.train.checkpoints.save_checkpoint`` and the port experiment of
the same variables (``from_flax``), patches both packages' prior noise to
one numpy slab (see ``tests/test_torch_decode.py``), and requires identical
caption strings from the two services.
"""
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acvae_tpu.data.vocab import Vocabulary as JVocabulary
from acvae_tpu_torch.data.vocab import Vocabulary as PortVocabulary
from acvae_tpu_torch.ops.audio import log_mel_spectrogram
from acvae_tpu_torch.serve import CaptionService, main, run_server
from acvae_tpu_torch.train.checkpoints import load_experiment, save_experiment
from tests.test_torch_decode import (FDIM, TMEL, V, fixed_eps,  # noqa: F401
                                     port_model, small_jax_model)
from tests.test_torch_decode import one_torch_thread  # noqa: F401

BUCKET, BATCH, MAXLEN = TMEL, 4, 8


class Vocabulary:
    """Stand-in for the upstream ``utils.build_vocab.Vocabulary``."""

    def __init__(self, words):
        self.word2idx = {w: i for i, w in enumerate(words)}
        self.idx2word = dict(enumerate(words))
        self.idx = len(words)


WORDS = ["<pad>", "<start>", "<end>", "<unk>"] + [f"w{i}" for i in range(4, V)]


def jax_vocab():
    v = JVocabulary()
    for w in WORDS[4:]:
        v.add_word(w)
    return v


# --------------------------------------------------------------------- #
# vocabulary
# --------------------------------------------------------------------- #
def test_vocab_loads_jax_and_upstream_pickles(tmp_path):
    jv = jax_vocab()
    jv.save(str(tmp_path / "jax.pkl"))
    with open(tmp_path / "instance.pkl", "wb") as f:
        pickle.dump(jv, f)                      # a pickled JAX Vocabulary
    with open(tmp_path / "upstream.pkl", "wb") as f:
        pickle.dump(Vocabulary(WORDS), f)       # the upstream class by name
    for name in ("jax.pkl", "instance.pkl", "upstream.pkl"):
        v = PortVocabulary.load(str(tmp_path / name))
        assert v.word2idx == jv.word2idx and len(v) == V, name
    v.save(str(tmp_path / "port.pkl"))
    assert JVocabulary.load(str(tmp_path / "port.pkl")).word2idx == jv.word2idx
    assert v("w7") == 7 and v("never-seen") == 3


def test_vocab_refuses_other_globals_and_foreign_order(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    (tmp_path / "evil.pkl").write_bytes(pickle.dumps({"word2idx": Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        PortVocabulary.load(str(tmp_path / "evil.pkl"))
    with open(tmp_path / "order.pkl", "wb") as f:
        pickle.dump({"word2idx": {"<start>": 0, "<pad>": 1, "<end>": 2,
                                  "<unk>": 3}}, f)
    with pytest.raises(ValueError, match="special token"):
        PortVocabulary.load(str(tmp_path / "order.pkl"))


def test_vocab_decode_matches_jax():
    pv, jv = PortVocabulary(), JVocabulary()
    for w in ("a", "<pad_0>", "b", "<pad_12>"):
        pv.add_word(w)
        jv.add_word(w)
    ids = [1, 4, 5, 6, 99, 7, 4, 2, 6, 4]
    assert pv.decode(ids) == jv.decode(ids) == ["a", "b", "<unk>", "a"]


# --------------------------------------------------------------------- #
# log-mel frontend
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("top_db", [None, 20.0], ids=["no_floor", "top_db"])
def test_log_mel_matches_jax(top_db):
    """A seeded 1 s wave at 32 kHz (its log-mel spans about 33 dB, so
    top_db 20 floors part of it): both frontends in float32 on the CPU.
    Measured max |diff| 5.7e-6 dB (two FFT libraries), held at 1e-4 dB."""
    from acvae_tpu.ops.audio import log_mel_spectrogram as j_log_mel
    from acvae_tpu.ops.audio import mel_filterbank as j_fbank
    from acvae_tpu_torch.ops.audio import mel_filterbank

    wave = (np.random.default_rng(0).normal(size=(2, 32000)) * 0.1
            ).astype(np.float32)
    ref = np.asarray(j_log_mel(jnp.asarray(wave), top_db=top_db))
    out = log_mel_spectrogram(torch.tensor(wave), top_db=top_db).numpy()
    assert out.shape == ref.shape == (2, 101, 64)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(mel_filterbank(32000, 1024, 64),
                                  j_fbank(32000, 1024, 64))
    assert not mel_filterbank(32000, 1024, 64).flags.writeable


# --------------------------------------------------------------------- #
# experiment dir
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """(jax_exp, port_exp, conf): one tiny Hybrid AC-VAE written by both
    packages from the same variables."""
    from acvae_tpu.train.checkpoints import save_checkpoint
    from acvae_tpu.train.trainer import TrainState

    conf, _, variables = small_jax_model(seed=3)
    root = tmp_path_factory.mktemp("serve_exps")
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              optax.adam(1e-3))
    save_checkpoint(str(root / "jax"), "best", state, jax_vocab(), dict(conf))
    save_experiment(str(root / "port"), port_model(conf, variables), conf,
                    PortVocabulary.load(str(root / "jax" / "vocab.pkl")))
    return str(root / "jax"), str(root / "port"), conf


def test_experiment_round_trip(experiments, tmp_path):
    _, port_exp, conf = experiments
    conf2, vocab, model = load_experiment(port_exp, device="cpu")
    assert conf2 == json.loads(json.dumps(conf)) and len(vocab) == V
    sd = torch.load(os.path.join(port_exp, "best.pt"), weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd["state_dict"][k]), k
    save_experiment(str(tmp_path), model, conf2, vocab, name="last")
    assert sorted(os.listdir(tmp_path)) == ["config.json", "last.pt", "vocab.pkl"]
    _, _, again = load_experiment(str(tmp_path), "last", device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(again.state_dict().values(), model.state_dict().values()))
    # a missing or an unexpected key raises
    for edit in ("drop", "extra"):
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        if edit == "drop":
            sd.pop("decoder.classifier.bias")
        else:
            sd["decoder.extra"] = torch.zeros(1)
        torch.save({"state_dict": sd}, tmp_path / f"{edit}.pt")
        with pytest.raises(RuntimeError, match="Missing|Unexpected"):
            load_experiment(str(tmp_path), edit, device="cpu")


# --------------------------------------------------------------------- #
# the end-to-end case: identical captions from both services
# --------------------------------------------------------------------- #
def _request_mels():
    rng = np.random.default_rng(11)
    full = rng.normal(size=(BUCKET, FDIM)).astype(np.float32)
    padded = rng.normal(size=(40, FDIM)).astype(np.float32)       # T < bucket
    cropped = rng.normal(size=(BUCKET + 30, FDIM)).astype(np.float32)
    return [full, padded, cropped]


def _quantize(mel):
    lo, hi = float(mel.min()), float(mel.max())
    scale = (hi - lo) / 255.0
    return (np.clip(np.round((mel - lo) / scale), 0, 255).astype(np.uint8),
            scale, lo)


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_caption_service_matches_jax(experiments, fixed_eps, method):
    from acvae_tpu.serve import CaptionService as JCaptionService

    jax_exp, port_exp, _ = experiments
    kw = dict(decode_method=method, batch_size=BATCH, mel_bucket=BUCKET,
              max_length=MAXLEN)
    jsvc = JCaptionService(jax_exp, **kw)
    psvc = CaptionService(port_exp, device="cpu", **kw)
    mels = _request_mels()
    ref = jsvc.caption(mels)
    assert psvc.caption(mels) == ref
    assert all(isinstance(c, str) for c in ref) and any(ref)
    q8 = [_quantize(m) for m in mels]
    ref_q = jsvc.caption(q8)
    assert psvc.caption(q8) == ref_q                    # all-uint8 batch
    mixed = [q8[1], mels[0]]                            # dequantized on the host
    assert psvc.caption(mixed) == jsvc.caption(mixed)
    with pytest.raises(ValueError):
        psvc.caption([np.zeros((16, FDIM + 1), np.float32)])
    with pytest.raises(ValueError):
        psvc.caption(mels + mels)                       # > batch_size


def test_uint8_paths_agree_with_f32(experiments, fixed_eps):
    """The on-device dequantization, the host one (mixed batch) and an f32
    batch of the dequantized values caption identically; the padding of a
    short clip is in the quantized domain."""
    _, port_exp, _ = experiments
    svc = CaptionService(port_exp, device="cpu", batch_size=2,
                         mel_bucket=BUCKET, max_length=MAXLEN)
    q, s, o = _quantize(_request_mels()[0])
    deq = q.astype(np.float32) * np.float32(s) + np.float32(o)
    short = (q[:17], s, o)
    assert svc.caption([(q, s, o)]) == svc.caption([deq])
    assert svc.caption([short, short])[0] == svc.caption([short, deq])[0]
    with pytest.raises(ValueError):
        svc.validate_q(q, 0.0, 0.0)
    with pytest.raises(ValueError):
        svc.validate_q(q.astype(np.int32) + 300, 1.0, 0.0)


@pytest.mark.parametrize("kwargs,error", [
    # what JAX refuses, the port refuses with the same error
    ({"encoder_int8": True, "decode_dtype": "bfloat16"},
     (ValueError, "decode_dtype")),
    ({"encoder_int8": True, "int8_scheme": "v9"}, (ValueError, "int8_scheme")),
    # at the baked flags' defaults, so that the missing artifact is what
    # raises (a changed one raises first: test_torch_export_serve.py)
    ({"exported": "artifact", "mel_bucket": 1024, "max_length": 20},
     (FileNotFoundError, "artifact")),
    ({"decode_dtype": "bfloat16"}, None),
    ({"upload_dtype": "float16"}, (ValueError, "upload_dtype must be")),
    ({"decode_method": "dbs", "beam_size": 2, "group_size": 4},
     (ValueError, "beam_size >= group_size")),
    ({"experiment_path": "PAIR", "decode_method": "sample"},
     (ValueError, "beam\\|greedy"))],
    ids=["int8", "int8_scheme", "exported", "decode_dtype", "upload_dtype",
         "dbs", "ensemble"])
def test_left_out_options_raise(experiments, kwargs, error):
    """The ValueErrors match JAX's service on the same input; a bf16
    decode_dtype runs (its decode state in bf16)."""
    from acvae_tpu.serve import CaptionService as JCaptionService

    jax_exp, port_exp, _ = experiments
    kw = {"device": "cpu", "batch_size": 2, "mel_bucket": BUCKET,
          "max_length": MAXLEN, **kwargs}
    kw.setdefault("experiment_path", port_exp)
    pair = kw["experiment_path"] == "PAIR"
    if pair:
        kw["experiment_path"] = f"{port_exp},{port_exp}"
    if error is None:
        svc = CaptionService(**kw)
        assert svc.model.decoder.state_dtype() == torch.bfloat16
        caps = svc.caption(_request_mels()[:2])
        assert len(caps) == 2 and all(isinstance(c, str) for c in caps)
        return
    with pytest.raises(error[0], match=error[1]):
        CaptionService(**kw)
    if error[0] is ValueError:
        jkw = {k: v for k, v in kw.items() if k != "device"}
        jkw["experiment_path"] = f"{jax_exp},{jax_exp}" if pair else jax_exp
        with pytest.raises(ValueError, match=error[1]):
            JCaptionService(**jkw)


def test_dbs_caption_service_matches_jax(experiments, monkeypatch):
    """DBS serving (b8 g4): the port fed the JAX service's draws (its key
    split once a caption call, warm-ups included)."""
    from acvae_tpu.serve import CaptionService as JCaptionService
    import acvae_tpu_torch.models.vae as tvae
    from tests.test_torch_dbs import jax_dbs_eps

    jax_exp, port_exp, conf = experiments
    kw = dict(decode_method="dbs", beam_size=8, group_size=4, batch_size=BATCH,
              mel_bucket=BUCKET, max_length=MAXLEN)
    jsvc = JCaptionService(jax_exp, **kw)
    _, model, variables = small_jax_model(seed=3)
    state = {"key": jax.random.key(3), "slabs": []}

    def eps_stack(steps, rows, dim, generator=None, device=None, dtype=None):
        if not state["slabs"]:
            state["key"], sub = jax.random.split(state["key"])
            state["slabs"] = list(jax_dbs_eps(model, variables, sub, 4, steps,
                                              rows))
        return torch.tensor(state["slabs"].pop(0), device=device)
    monkeypatch.setattr(tvae, "eps_stack", eps_stack)
    psvc = CaptionService(port_exp, device="cpu", **kw)
    mels = _request_mels()
    assert psvc.caption(mels) == jsvc.caption(mels)
    q8 = [_quantize(m) for m in mels]
    assert psvc.caption(q8) == jsvc.caption(q8)


def test_upload_bf16_service_matches_jax(experiments, fixed_eps):
    """upload_dtype=bfloat16: the f32 batches are cast on the host; the
    captions equal JAX's, and equal those of an f32 service given the
    bf16-rounded mels."""
    from acvae_tpu.serve import CaptionService as JCaptionService

    jax_exp, port_exp, _ = experiments
    kw = dict(batch_size=BATCH, mel_bucket=BUCKET, max_length=MAXLEN)
    jsvc = JCaptionService(jax_exp, upload_dtype="bfloat16", **kw)
    psvc = CaptionService(port_exp, device="cpu", upload_dtype="bfloat16", **kw)
    mels = _request_mels()
    ours = psvc.caption(mels)
    assert ours == jsvc.caption(mels)
    plain = CaptionService(port_exp, device="cpu", **kw)
    rounded = [torch.tensor(m).to(torch.bfloat16).float().numpy() for m in mels]
    assert plain.caption(rounded) == ours


def test_other_model_families_and_no_card_raise(experiments, tmp_path):
    _, port_exp, conf = experiments
    _, vocab, model = load_experiment(port_exp, device="cpu")
    save_experiment(str(tmp_path), model, dict(conf, model="GlobalVAEModel"),
                    vocab)
    with pytest.raises(NotImplementedError):
        CaptionService(str(tmp_path), device="cpu")
    if torch.cuda.is_available():
        return  # the no-card refusal is checked on machines without one
    with pytest.raises(RuntimeError, match="CUDA"):
        CaptionService(port_exp)


# --------------------------------------------------------------------- #
# HTTP
# --------------------------------------------------------------------- #
def _post(port, data, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/caption", data=data,
                                 headers=headers)
    return json.loads(urllib.request.urlopen(req, timeout=120).read())


def _status(port, data, headers):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, data, headers)
    return e.value.code


def test_http_server_round_trip(experiments):
    svc = CaptionService(experiments[1], device="cpu", batch_size=2,
                         mel_bucket=BUCKET, max_length=MAXLEN)
    server = run_server(svc, port=0, block=False, max_wait_ms=5.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    js = {"Content-Type": "application/json"}
    try:
        port = server.server_address[1]
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=30).read())
        assert health == {"status": "ok", "batch_size": 2, "mel_bucket": BUCKET}
        mel = _request_mels()[1]
        q, s, o = _quantize(mel)
        replies = [
            _post(port, json.dumps({"mel": mel.tolist()}).encode(), js),
            _post(port, np.ascontiguousarray(mel, "<f4").tobytes(),
                  {"Content-Type": "application/octet-stream",
                   "X-Mel-Frames": str(mel.shape[0]),
                   "X-Mel-Bins": str(FDIM)}),
            _post(port, q.tobytes(),
                  {"Content-Type": "application/octet-stream",
                   "X-Mel-Frames": str(q.shape[0]), "X-Mel-Bins": str(FDIM),
                   "X-Mel-Dtype": "uint8", "X-Mel-Scale": str(s),
                   "X-Mel-Offset": str(o)}),
            _post(port, json.dumps({"mel_q8": q.tolist(), "scale": s,
                                    "offset": o}).encode(), js),
            _post(port, json.dumps({"wav": [0.0] * 3200, "sr": 32000}).encode(),
                  js),
        ]
        assert all(isinstance(r["caption"], str) for r in replies)
        bad = [_status(port, json.dumps({"nope": 1}).encode(), js),
               _status(port, json.dumps({"mel_q8": q.tolist()}).encode(), js),
               _status(port, q.tobytes(),
                       {"Content-Type": "application/octet-stream",
                        "X-Mel-Frames": str(q.shape[0]),
                        "X-Mel-Bins": str(FDIM), "X-Mel-Dtype": "int16"})]
        assert bad == [400, 400, 400]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert e.value.code == 404
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=30).read())
        assert snap["requests"] == 8 and snap["ok"] == 5
        assert snap["client_errors"] == 3 and snap["server_errors"] == 0
        assert snap["timeouts"] == 0 and snap["batched_requests"] == 5
        assert 1 <= snap["batches"] <= 5 and snap["queue_depth"] == 0
        assert snap["latency_ms_p50"] > 0 and snap["uptime_s"] >= 0
    finally:
        server._acvae_stop()
        thread.join(timeout=10)
        server.server_close()
    assert not thread.is_alive()


def test_batcher_drops_abandoned_requests(experiments):
    svc = CaptionService(experiments[1], device="cpu", batch_size=2,
                         mel_bucket=BUCKET, max_length=MAXLEN)
    decoded = []
    real_caption = svc.caption
    svc.caption = lambda mels: decoded.append(len(mels)) or real_caption(mels)
    server = run_server(svc, port=0, block=False, max_wait_ms=5.0)
    try:
        q, mel = server._acvae_queue, _request_mels()[0]
        dead_evt, dead_cancel = threading.Event(), threading.Event()
        dead_cancel.set()
        q.put((mel, {}, dead_evt, dead_cancel))
        live_res, live_evt = {}, threading.Event()
        q.put((mel, live_res, live_evt, threading.Event()))
        assert live_evt.wait(timeout=120.0)
        assert isinstance(live_res["caption"], str)
        assert not dead_evt.is_set() and decoded == [1]
    finally:
        # serve_forever never ran: stop the batcher and close the socket
        server._acvae_queue.put(None)
        server.server_close()


def test_main_parses_the_diverse_flags(experiments, monkeypatch):
    """--decode_method dbs with its knobs, --decode_dtype, --upload_dtype
    and a comma-separated ensemble reach the service."""
    import acvae_tpu_torch.serve as serve_mod

    got = {}
    monkeypatch.setattr(serve_mod, "run_server",
                        lambda svc, **kw: got.update(svc=svc))
    port_exp = experiments[1]
    base = ["--device", "cpu", "--batch_size", "2", "--mel_bucket", str(BUCKET),
            "--max_length", "4"]
    main([port_exp] + base + ["--decode_method", "dbs", "--beam_size", "4",
                              "--group_size", "2", "--diversity_lambda", "0.3",
                              "--group_nbest", "false", "--upload_dtype",
                              "bfloat16"])
    svc = got["svc"]
    assert svc._decode_kwargs == dict(decode_method="dbs", max_length=4,
                                      beam_size=4, group_size=2,
                                      diversity_lambda=0.3, group_nbest=False)
    assert svc._upload_dtype == torch.bfloat16
    main([port_exp] + base + ["--decode_dtype", "bfloat16"])
    assert got["svc"].model.decoder.state_dtype() == torch.bfloat16
    main([f"{port_exp},{port_exp}"] + base)
    assert len(got["svc"].members) == 2


def test_main_parses_the_serve_flags(experiments, monkeypatch):
    import acvae_tpu_torch.serve as serve_mod

    got = {}
    monkeypatch.setattr(serve_mod, "run_server",
                        lambda svc, **kw: got.update(svc=svc, **kw))
    main([experiments[1], "--device", "cpu", "--port", "0", "--batch_size", "2",
          "--mel_bucket", str(BUCKET), "--max_length", "4", "--decode_method",
          "greedy", "--max_wait_ms", "7"])
    svc = got["svc"]
    assert (svc.batch_size, svc.bucket) == (2, BUCKET)
    assert got == {"svc": svc, "host": "127.0.0.1", "port": 0, "max_wait_ms": 7.0}
    assert len(svc.caption([_request_mels()[0]])) == 1
