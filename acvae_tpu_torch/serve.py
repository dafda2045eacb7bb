"""Caption serving (counterpart of ``acvae_tpu/serve.py:42-603`` and
``acvae_tpu/cli/main.py:1146-1206``).

* :class:`CaptionService` loads an experiment dir (``config.json``,
  ``vocab.pkl``, ``<checkpoint>.pt``; see ``train/checkpoints.py``), pads
  every request to one mel bucket and every batch to ``batch_size``, and
  serves ``caption(mels) -> [str]``.
* :func:`run_server` is the micro-batching HTTP front end: ``POST
  /caption`` with JSON ``{"mel": [[T×F]]}``, ``{"mel_q8": [[T×F uint8]],
  "scale": s, "offset": o}`` (``mel ≈ q·s + o``) or ``{"wav": [...],
  "sr": N}``, or a binary body (``application/octet-stream`` with
  ``X-Mel-Frames``/``X-Mel-Bins``; raw little-endian float32, or with
  ``X-Mel-Dtype: uint8`` and ``X-Mel-Scale``/``X-Mel-Offset`` the codes);
  the reply is ``{"caption": "..."}``.  ``GET /health`` and ``GET /stats``
  report readiness and counters.  Requests queue and decode together, up to
  ``batch_size`` or ``max_wait_ms``, whichever comes first.

With ``encoder_int8=True`` (``--encoder_int8``) the service encodes with the
int8 serving encoder (``models/quant.py``; scheme ``int8_scheme``, flag
``--int8_scheme``, default ``v2sym``), calibrated at start-up from bn0's
running statistics on the service's device, for f32 and uint8 batches alike;
on the card its convs and pools are the hand-written kernels of
``ops/cuda/conv_i8_kernel.py``.

``decode_method="dbs"`` serves the top caption of a diverse beam search
(``group_size``, ``diversity_lambda``, ``temperature``, ``group_nbest``);
``decode_dtype="bfloat16"`` decodes with the parameters cast
(``ops/amp.py``); ``upload_dtype="bfloat16"`` casts an f32 batch on the host
before its upload.  A comma-separated ``experiment_path`` (or a list)
serves the probability-averaged ensemble of its experiments
(``decoding/ensemble.py``; beam or greedy, float32, one vocabulary and mel
dim).

With ``exported=<dir>`` (``--exported``) it serves an ``export_model``
artifact (``export.py``) without the experiment: the vocabulary, the mel
bucket and the mel dim are the artifact's, a pinned batch overrides
``batch_size``, uint8 requests are dequantized on the host, and each batch
draws its noise from a uint32 seed counter that starts at ``seed + 2``.  The
decode flags are baked into the artifact: changing one from its default,
or passing a decode kwarg, raises.

Run it as ``python -m acvae_tpu_torch.serve <exp_dir>[,<exp_dir>...]
[--port ...] [--encoder_int8 [--int8_scheme v2sym]] [--decode_method dbs
--group_size 4 ...] [--decode_dtype bfloat16] [--upload_dtype bfloat16]``,
or ``python -m acvae_tpu_torch.serve --exported <export_dir>``; the CLI's
``serve`` command takes the same arguments.  Both go through :func:`serve`.
"""
from __future__ import annotations

import argparse
import collections
import inspect
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.data.vocab import Vocabulary
from acvae_tpu_torch.decoding.ensemble import check_step_api, ensemble_decode
from acvae_tpu_torch.export import load_exported
from acvae_tpu_torch.models.quant import (DEFAULT_INT8_SCHEME, SCHEMES,
                                          int8_decode_fn, quant_encoder_for,
                                          scheme_kwargs)
from acvae_tpu_torch.models.common import check_decode_method
from acvae_tpu_torch.ops.amp import cast_floats_for_decode, resolve_decode_dtype
from acvae_tpu_torch.train.checkpoints import load_experiment


class CaptionService:
    """Fixed-shape batched decoding over an experiment dir."""

    def __init__(self, experiment_path=None, checkpoint: str = "best",
                 decode_method: str = "beam", beam_size: int = 3,
                 max_length: int = 20, batch_size: int = 16,
                 mel_bucket: int = 1024, seed: int = 1,
                 device=DEFAULT_DEVICE, encoder_int8: bool = False,
                 int8_scheme: str = DEFAULT_INT8_SCHEME,
                 exported: Optional[str] = None,
                 upload_dtype: str = "float32",
                 decode_dtype: Optional[str] = None, **decode_kwargs):
        """``decode_kwargs``: the decode's extra knobs (dbs: ``group_size``,
        ``diversity_lambda``, ``temperature``, ``group_nbest``; sampling:
        ``temp``)."""
        if exported is None and experiment_path is None:
            raise ValueError("serve needs an experiment dir or --exported")
        if upload_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"upload_dtype must be float32 or bfloat16, "
                             f"got {upload_dtype!r}")
        if decode_dtype and encoder_int8:
            raise ValueError("decode_dtype does not combine with "
                             "encoder_int8 (the int8 path fixes its own "
                             "precision); pick one serving mode")
        if upload_dtype == "bfloat16" and exported is not None:
            raise ValueError("upload_dtype does not apply to an exported "
                             "artifact (its input dtype is baked at export "
                             "time)")
        scheme = scheme_kwargs(int8_scheme) if encoder_int8 else None
        paths = None
        if isinstance(experiment_path, (list, tuple)):
            paths = [str(p) for p in experiment_path]
        elif "," in str(experiment_path):
            paths = [p for p in str(experiment_path).split(",") if p]
        self.members = None
        if paths is not None and len(paths) > 1:
            if exported is not None or encoder_int8 or decode_dtype:
                raise ValueError(
                    "ensemble serving composes with the plain f32 decode "
                    "only (not --exported / --encoder_int8 / "
                    "--decode_dtype)")
            if decode_kwargs:
                raise ValueError(
                    f"decode kwargs {sorted(decode_kwargs)} do not apply "
                    "to ensemble serving (beam/greedy only)")
            if decode_method not in ("beam", "greedy"):
                raise ValueError(
                    "ensemble serving supports decode_method=beam|greedy "
                    f"(the reference ensemble's surface), got "
                    f"{decode_method!r}")
        elif exported is not None:
            # the artifact bakes the decode in: a flag changed from its
            # default, or any decode kwarg, raises rather than be ignored
            # (``acvae_tpu/cli/main.py:1173-1196``)
            baked = dict(decode_method=decode_method, beam_size=beam_size,
                         max_length=max_length, mel_bucket=mel_bucket,
                         checkpoint=checkpoint, encoder_int8=encoder_int8,
                         int8_scheme=int8_scheme, decode_dtype=decode_dtype)
            defaults = inspect.signature(CaptionService).parameters
            changed = [k for k, v in baked.items() if v != defaults[k].default]
            changed += [f"{k}(decode kwarg)" for k in decode_kwargs]
            if changed:
                raise ValueError(
                    f"flag(s) --{', --'.join(changed)} do not apply to an "
                    f"exported artifact: the decode config and precision "
                    f"are fixed at export time — set them on "
                    f"`export_model` and re-export")
        check_decode_method("CaptionService", decode_method)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CaptionService(device='cuda') needs a CUDA "
                               "card; pass device='cpu' to run on the CPU")
        self._upload_dtype = (torch.bfloat16 if upload_dtype == "bfloat16"
                              else None)
        self.batch_size = batch_size
        self.bucket = mel_bucket
        self.quant = None
        self.exported = None
        if exported is not None:
            self._load_exported(exported, batch_size, seed)
        elif paths is not None and len(paths) > 1:
            self._load_ensemble(paths, checkpoint)
            self._decode_kwargs = dict(decode_method=decode_method,
                                       beam_size=beam_size,
                                       max_length=max_length)
        else:
            self.conf, self.vocab, self.model = load_experiment(
                paths[0] if paths else experiment_path, checkpoint,
                device=self.device)
            self.data_dim = int(self.conf.get("data_dim", 64))
            self._decode_kwargs = dict(decode_method=decode_method,
                                       max_length=max_length,
                                       beam_size=beam_size, **decode_kwargs)
            # the int8 serving encoder, calibrated from bn0's running
            # statistics (no training data at serving time)
            if encoder_int8:
                self.quant = quant_encoder_for(self.conf, self.model, **scheme)
            dt = resolve_decode_dtype(decode_dtype)
            if dt is not None:
                self.model = cast_floats_for_decode(self.model, dt)
        self._gen = torch.Generator(self.device).manual_seed(seed + 2)
        self._lock = threading.Lock()
        # warm both upload paths so the first live batch of either kind
        # does not pay the set-up (cuDNN algorithm choice, the kernels'
        # build and load, allocator growth)
        self.caption([np.zeros((64, self.data_dim), np.float32)])
        if self.exported is None:   # an artifact's uint8 batches are f32 ones
            self.caption([(np.zeros((64, self.data_dim), np.uint8), 1.0, 0.0)])

    def _load_exported(self, export_dir: str, batch_size: int, seed: int) -> None:
        """An ``export_model`` artifact (``acvae_tpu/serve.py:127-145``):
        its vocabulary, mel bucket and mel dim; a pinned batch overrides
        ``batch_size``.  Each batch's noise comes from a uint32 seed counter
        that starts at ``seed + 2``, so a new service repeats its captions."""
        self.exported, meta = load_exported(export_dir, self.device)
        self.vocab = Vocabulary.load(str(Path(export_dir) / "vocab.pkl"))
        self.bucket = int(meta["t_mel"])
        self.data_dim = int(meta["n_mels"])
        if meta["batch"] != "symbolic":
            if batch_size != int(meta["batch"]):
                print(f"[serve] exported artifact pins batch={meta['batch']}; "
                      f"ignoring --batch_size={batch_size}", file=sys.stderr)
            self.batch_size = int(meta["batch"])
        self._seed = np.uint32(seed + 2)

    def _load_ensemble(self, paths: List[str], checkpoint: str) -> None:
        """The members' experiments: one vocabulary and one mel dim."""
        self.members = []
        for p in paths:
            conf, vocab, model = load_experiment(p, checkpoint,
                                                 device=self.device)
            if not self.members:
                self.conf, self.vocab = conf, vocab
                self.data_dim = int(conf.get("data_dim", 64))
            elif vocab.word2idx != self.vocab.word2idx:
                raise ValueError(
                    f"ensemble members must share one vocabulary; "
                    f"{p} differs from {paths[0]}")
            elif int(conf.get("data_dim", 64)) != self.data_dim:
                raise ValueError(
                    f"ensemble members must share the mel dim; {p} has "
                    f"{conf.get('data_dim')} vs {self.data_dim}")
            self.members.append(model)
        check_step_api(self.members)

    def validate(self, mel) -> np.ndarray:
        """Shape-check one request's mel, per request and before batching,
        so that one malformed request cannot fail its micro-batch."""
        mel = np.asarray(mel, np.float32)
        if mel.ndim != 2 or mel.shape[1] != self.data_dim:
            raise ValueError(f"mel must be [T, {self.data_dim}], "
                             f"got {mel.shape}")
        return mel

    def validate_q(self, q, scale, offset):
        """Check one client-quantized request: uint8 codes [T, F] and the
        clip's affine ``mel ≈ q·scale + offset``."""
        q = np.asarray(q)
        if q.dtype != np.uint8:
            q2 = q.astype(np.uint8)
            if not np.array_equal(q2, q):
                raise ValueError("mel_q8 codes must be uint8 (0..255)")
            q = q2
        if q.ndim != 2 or q.shape[1] != self.data_dim:
            raise ValueError(f"mel_q8 must be [T, {self.data_dim}], "
                             f"got {q.shape}")
        scale, offset = float(scale), float(offset)
        if not (np.isfinite(scale) and scale > 0 and np.isfinite(offset)):
            raise ValueError(f"bad quantization affine: scale={scale}, "
                             f"offset={offset}")
        return q, scale, offset

    def _prep(self, mel: np.ndarray):
        mel = self.validate(mel)
        T = min(mel.shape[0], self.bucket)
        out = np.zeros((self.bucket, self.data_dim), np.float32)
        out[:T] = mel[:T]
        return out, T

    def _prep_q(self, q: np.ndarray, scale: float, offset: float):
        T = min(q.shape[0], self.bucket)
        # pad with the code that decodes nearest 0.0, as the f32 path pads
        # with zeros, so a clip captions the same in either kind of batch
        pad = np.uint8(np.clip(np.round(-offset / scale), 0, 255))
        out = np.full((self.bucket, self.data_dim), pad, np.uint8)
        out[:T] = q[:T]
        return out, T

    def caption(self, mels: List) -> List[str]:
        """Caption up to ``batch_size`` clips.  Each entry is a float32
        log-mel [T, F] or a ``(q_uint8, scale, offset)`` tuple.  An
        all-uint8 batch is uploaded as uint8 and dequantized on the device;
        a mixed batch is dequantized on the host.  Both compute ``q·s``,
        then ``+ o``, each rounded to float32, so both give the same
        values."""
        if len(mels) > self.batch_size:
            raise ValueError(f"batch too large: {len(mels)} > "
                             f"{self.batch_size}")
        lens = np.ones((self.batch_size,), np.int64)
        if mels and self.exported is None and all(isinstance(m, tuple)
                                                   for m in mels):
            q = np.zeros((self.batch_size, self.bucket, self.data_dim), np.uint8)
            scales = np.ones((self.batch_size,), np.float32)
            offsets = np.zeros((self.batch_size,), np.float32)
            for i, entry in enumerate(mels):
                qi, s, o = self.validate_q(*entry)
                q[i], lens[i] = self._prep_q(qi, s, o)
                scales[i], offsets[i] = s, o
            with record_function("upload"):
                q, scales, offsets, lens = (torch.from_numpy(a).to(self.device)
                                            for a in (q, scales, offsets, lens))
            feats = q.float() * scales[:, None, None] + offsets[:, None, None]
            return self._decode(feats, lens, len(mels))
        feats = np.zeros((self.batch_size, self.bucket, self.data_dim),
                         np.float32)
        for i, mel in enumerate(mels):
            if isinstance(mel, tuple):
                q, s, o = self.validate_q(*mel)
                qp, lens[i] = self._prep_q(q, s, o)
                feats[i] = qp.astype(np.float32) * np.float32(s) + np.float32(o)
            else:
                feats[i], lens[i] = self._prep(mel)
        feats = torch.from_numpy(feats)
        if self._upload_dtype is not None:
            # halve the upload; the encoder computes in float32 again
            feats = feats.to(self._upload_dtype)
        with record_function("upload"):
            feats, lens = (t.to(self.device) for t in (feats, torch.from_numpy(lens)))
        return self._decode(feats.float(), lens, len(mels))

    def _decode(self, feats: torch.Tensor, lens: torch.Tensor, n: int) -> List[str]:
        with self._lock:
            if self.exported is not None:
                seed = int(self._seed)
                self._seed = np.uint32((seed + 1) % 2**32)
                out = self.exported(feats, lens.to(torch.int32), seed)
            elif self.members is not None:
                out = ensemble_decode(self.members, feats, lens,
                                      generator=self._gen,
                                      **self._decode_kwargs)
            elif self.quant is not None:
                out = int8_decode_fn(self.model, self.quant, **self._decode_kwargs)(
                    feats, lens, generator=self._gen)
            else:
                out = self.model.inference_forward(
                    feats, lens, generator=self._gen, **self._decode_kwargs)
        return self._to_captions(out, n)

    def _to_captions(self, out, n: int) -> List[str]:
        seqs = out["seqs"].cpu().numpy()
        if seqs.ndim == 3:  # beam: take the top beam
            seqs = seqs[:, 0]
        return [" ".join(self.vocab.decode(seq)) for seq in seqs[:n]]


def run_server(service: CaptionService, host: str = "127.0.0.1",
               port: int = 8976, max_wait_ms: float = 20.0,
               block: bool = True):
    """Micro-batching HTTP front end over a :class:`CaptionService`.

    With ``block=False`` it returns the server unstarted: the caller runs
    ``serve_forever`` (e.g. in a thread) and stops it with
    ``server._acvae_stop()``."""
    requests: "queue.Queue" = queue.Queue()
    # counters for GET /stats; handlers run in the server's threads and the
    # batcher in its own, so every update takes the lock
    stats_lock = threading.Lock()
    stats = {"started_at": time.time(), "requests": 0, "ok": 0,
             "client_errors": 0, "server_errors": 0, "timeouts": 0,
             "dropped_after_timeout": 0, "batches": 0, "batched_requests": 0}
    latencies: "collections.deque" = collections.deque(maxlen=1000)

    def _bump(key, n=1):
        with stats_lock:
            stats[key] += n

    def batcher():
        while True:
            first = requests.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + max_wait_ms / 1000.0
            while len(batch) < service.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = requests.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    return
                batch.append(item)
            # drop requests whose handler already timed out (504 sent): a
            # backlog must not spend decode slots on abandoned clients
            kept = [b for b in batch if not b[3].is_set()]
            _bump("dropped_after_timeout", len(batch) - len(kept))
            batch = kept
            if not batch:
                continue
            _bump("batches")
            _bump("batched_requests", len(batch))
            try:
                captions = service.caption([mel for mel, _, _, _ in batch])
                for (_, result, event, _), cap in zip(batch, captions):
                    result["caption"] = cap
                    event.set()
            except Exception as e:  # reported to every client as a 500
                for _, result, event, _ in batch:
                    result["error"] = f"{type(e).__name__}: {e}"
                    event.set()

    threading.Thread(target=batcher, daemon=True).start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok",
                                  "batch_size": service.batch_size,
                                  "mel_bucket": service.bucket})
            elif self.path == "/stats":
                with stats_lock:
                    snap = dict(stats)
                    lat = sorted(latencies)
                snap["uptime_s"] = round(time.time() - snap.pop("started_at"),
                                         1)
                snap["queue_depth"] = requests.qsize()
                snap["mean_batch_size"] = round(
                    snap["batched_requests"] / snap["batches"], 2) \
                    if snap["batches"] else None
                if lat:
                    snap["latency_ms_p50"] = round(
                        lat[len(lat) // 2] * 1000, 1)
                    # nearest-rank p95: ceil(0.95·n) - 1
                    p95_i = max(0, -(-len(lat) * 95 // 100) - 1)
                    snap["latency_ms_p95"] = round(lat[p95_i] * 1000, 1)
                self._reply(200, snap)
            else:
                self._reply(404, {"error": "unknown path"})

        def _read_mel(self):
            """The request's mel: a float32 array or a validated
            ``(q, scale, offset)`` tuple; raises on a malformed request."""
            length = int(self.headers.get("Content-Length", 0))
            if self.headers.get("Content-Type", "") == "application/octet-stream":
                t = int(self.headers["X-Mel-Frames"])
                f = int(self.headers["X-Mel-Bins"])
                dt = self.headers.get("X-Mel-Dtype", "float32")
                if dt == "uint8":
                    q = np.frombuffer(self.rfile.read(length),
                                      dtype=np.uint8).reshape(t, f)
                    return service.validate_q(q, self.headers["X-Mel-Scale"],
                                              self.headers["X-Mel-Offset"])
                if dt != "float32":
                    raise ValueError(f"X-Mel-Dtype must be float32 or uint8, "
                                     f"got {dt!r}")
                return service.validate(np.frombuffer(
                    self.rfile.read(length), dtype="<f4").reshape(t, f))
            req = json.loads(self.rfile.read(length))
            if "mel" in req:
                return service.validate(req["mel"])
            if "mel_q8" in req:
                # scale and offset are required: defaults would read raw
                # codes as mel values
                return service.validate_q(np.asarray(req["mel_q8"]),
                                          req["scale"], req["offset"])
            if "wav" in req:
                from acvae_tpu_torch.ops.audio import log_mel_spectrogram
                wave = torch.tensor(np.asarray(req["wav"], np.float32),
                                    device=service.device)
                return service.validate(log_mel_spectrogram(
                    wave[None], sr=int(req.get("sr", 32000)),
                    n_mels=service.data_dim)[0].cpu().numpy())
            raise ValueError("need 'mel', 'mel_q8' or 'wav'")

        def do_POST(self):
            if self.path != "/caption":
                self._reply(404, {"error": "unknown path"})
                return
            t_arrival = time.monotonic()
            _bump("requests")
            try:
                mel = self._read_mel()
            except Exception as e:  # any malformed request is a 400
                _bump("client_errors")
                self._reply(400, {"error": f"bad request: {e}"})
                return
            result: dict = {}
            event = threading.Event()
            cancelled = threading.Event()
            requests.put((mel, result, event, cancelled))
            if not event.wait(timeout=120.0):
                cancelled.set()  # the batcher skips it if still queued
                _bump("timeouts")
                self._reply(504, {"error": "decode timeout"})
                return
            if "error" in result:
                _bump("server_errors")
                self._reply(500, result)
            else:
                _bump("ok")
                with stats_lock:
                    latencies.append(time.monotonic() - t_arrival)
                self._reply(200, result)

    class _Server(ThreadingHTTPServer):
        # the default accept backlog (5) refuses connections under
        # concurrent load well below the decode's capacity
        request_queue_size = 128

    server = _Server((host, port), Handler)
    server._acvae_stop = lambda: (requests.put(None), server.shutdown())
    server._acvae_queue = requests  # for tests and operational probes
    if block:
        print(f"serving on http://{host}:{server.server_address[1]} "
              f"(POST /caption, GET /health, GET /stats)", flush=True)
        try:
            server.serve_forever()
        finally:
            requests.put(None)
            server.server_close()
    return server


def serve(experiment_path: Optional[str] = None, **kwargs) -> None:
    """Build a :class:`CaptionService` and serve it until interrupted: the
    front end of ``python -m acvae_tpu_torch.serve`` and of the CLI's
    ``serve``.  ``kwargs`` are :func:`run_server`'s ``host``, ``port`` and
    ``max_wait_ms`` and the service's arguments, each at its default when
    absent."""
    server = {k: kwargs.pop(k) for k in ("host", "port", "max_wait_ms")
              if k in kwargs}
    run_server(CaptionService(experiment_path, **kwargs), **server)


def main(argv=None):
    # the service's flags are passed only when given, so that their
    # defaults are CaptionService's, written once
    ap = argparse.ArgumentParser(
        description="Serve captions over HTTP from a port experiment dir.",
        argument_default=argparse.SUPPRESS)
    ap.add_argument("experiment_path", nargs="?", default=None,
                    help="an experiment dir, or several joined by commas "
                         "(an ensemble); not with --exported")
    ap.add_argument("--exported",
                    help="serve an export_model artifact directory instead")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8976)
    ap.add_argument("--max_wait_ms", type=float, default=20.0)
    ap.add_argument("--checkpoint")
    ap.add_argument("--decode_method",
                    choices=("beam", "greedy", "gumbel", "sample", "dbs"))
    for name in ("beam_size", "max_length", "batch_size", "mel_bucket", "seed"):
        ap.add_argument(f"--{name}", type=int)
    ap.add_argument("--device")
    ap.add_argument("--encoder_int8", action="store_true",
                    help="encode with the int8 serving encoder, calibrated "
                         "from bn0's running statistics")
    ap.add_argument("--int8_scheme", choices=sorted(SCHEMES),
                    help="quantization scheme of --encoder_int8 "
                         f"(default {DEFAULT_INT8_SCHEME})")
    ap.add_argument("--decode_dtype",
                    help="decode with the parameters in this dtype "
                         "(bfloat16)")
    ap.add_argument("--upload_dtype", choices=("float32", "bfloat16"))
    knobs = ap.add_argument_group("decode knobs (passed only when given)")
    for name, typ in (("group_size", int), ("diversity_lambda", float),
                      ("temperature", float), ("temp", float)):
        knobs.add_argument(f"--{name}", type=typ)
    knobs.add_argument("--group_nbest",
                       type=lambda v: v.lower() in ("1", "true", "yes"))
    serve(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
