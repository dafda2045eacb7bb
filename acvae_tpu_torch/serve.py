"""Caption serving (counterpart of ``acvae_tpu/serve.py:42-603`` and
``acvae_tpu/cli/main.py:1146-1205``).

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

Run it as ``python -m acvae_tpu_torch.serve <exp_dir> [--port ...]
[--encoder_int8 [--int8_scheme v2sym]]``.
"""
from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from acvae_tpu_torch import DEFAULT_DEVICE
from acvae_tpu_torch.models.quant import (DEFAULT_INT8_SCHEME, SCHEMES,
                                          int8_decode_fn, quant_encoder_for,
                                          scheme_kwargs)
from acvae_tpu_torch.models.vae import _check_decode_method
from acvae_tpu_torch.train.checkpoints import load_experiment


class CaptionService:
    """Fixed-shape batched decoding over an experiment dir."""

    def __init__(self, experiment_path: str, checkpoint: str = "best",
                 decode_method: str = "beam", beam_size: int = 3,
                 max_length: int = 20, batch_size: int = 16,
                 mel_bucket: int = 1024, seed: int = 1,
                 device=DEFAULT_DEVICE, encoder_int8: bool = False,
                 int8_scheme: str = DEFAULT_INT8_SCHEME,
                 exported: Optional[str] = None,
                 upload_dtype: str = "float32",
                 decode_dtype: Optional[str] = None, temp: float = 1.0):
        if decode_dtype and encoder_int8:
            raise ValueError("decode_dtype does not combine with "
                             "encoder_int8 (the int8 path fixes its own "
                             "precision); pick one serving mode")
        scheme = scheme_kwargs(int8_scheme) if encoder_int8 else None
        if exported is not None:
            raise NotImplementedError("serving an exported artifact is not "
                                      "ported (ROADMAP A18, torch.export)")
        if decode_dtype is not None or upload_dtype != "float32":
            raise NotImplementedError("decode_dtype / upload_dtype="
                                      f"{upload_dtype!r} are not ported "
                                      "(ROADMAP A14, ops/amp.py)")
        if "," in str(experiment_path):
            raise NotImplementedError("ensemble serving is not ported "
                                      "(ROADMAP A14)")
        _check_decode_method("CaptionService", decode_method)
        if decode_method == "dbs":
            raise NotImplementedError("diverse beam search is not ported "
                                      "(ROADMAP A14)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CaptionService(device='cuda') needs a CUDA "
                               "card; pass device='cpu' to run on the CPU")
        self.conf, self.vocab, self.model = load_experiment(
            experiment_path, checkpoint, device=self.device)
        self.batch_size = batch_size
        self.bucket = mel_bucket
        self.data_dim = int(self.conf.get("data_dim", 64))
        self._decode_kwargs = dict(decode_method=decode_method,
                                   max_length=max_length, beam_size=beam_size,
                                   temp=temp)
        # the int8 serving encoder, calibrated from bn0's running statistics
        # (no training data at serving time); None serves the f32 encoder
        self.quant = (quant_encoder_for(self.conf, self.model, **scheme)
                      if encoder_int8 else None)
        self._gen = torch.Generator(self.device).manual_seed(seed + 2)
        self._lock = threading.Lock()
        # warm both upload paths so the first live batch of either kind
        # does not pay the set-up (cuDNN algorithm choice, the kernels'
        # build and load, allocator growth)
        self.caption([np.zeros((64, self.data_dim), np.float32)])
        self.caption([(np.zeros((64, self.data_dim), np.uint8), 1.0, 0.0)])

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
        if mels and all(isinstance(m, tuple) for m in mels):
            q = np.zeros((self.batch_size, self.bucket, self.data_dim), np.uint8)
            scales = np.ones((self.batch_size,), np.float32)
            offsets = np.zeros((self.batch_size,), np.float32)
            for i, entry in enumerate(mels):
                qi, s, o = self.validate_q(*entry)
                q[i], lens[i] = self._prep_q(qi, s, o)
                scales[i], offsets[i] = s, o
            dev = self.device
            feats = (torch.from_numpy(q).to(dev).float()
                     * torch.from_numpy(scales).to(dev)[:, None, None])
            feats = feats + torch.from_numpy(offsets).to(dev)[:, None, None]
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
        return self._decode(torch.from_numpy(feats).to(self.device), lens,
                            len(mels))

    def _decode(self, feats: torch.Tensor, lens: np.ndarray, n: int) -> List[str]:
        lens = torch.from_numpy(lens).to(self.device)
        with self._lock:
            if self.quant is not None:
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


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve captions over HTTP from a port experiment dir.")
    ap.add_argument("experiment_path")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8976)
    ap.add_argument("--checkpoint", default="best")
    ap.add_argument("--decode_method", default="beam",
                    choices=("beam", "greedy", "gumbel", "sample"))
    ap.add_argument("--beam_size", type=int, default=3)
    ap.add_argument("--max_length", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--mel_bucket", type=int, default=1024)
    ap.add_argument("--max_wait_ms", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--encoder_int8", action="store_true",
                    help="encode with the int8 serving encoder, calibrated "
                         "from bn0's running statistics")
    ap.add_argument("--int8_scheme", default=DEFAULT_INT8_SCHEME,
                    choices=sorted(SCHEMES),
                    help="quantization scheme of --encoder_int8 "
                         f"(default {DEFAULT_INT8_SCHEME})")
    args = ap.parse_args(argv)
    service = CaptionService(
        args.experiment_path, checkpoint=args.checkpoint,
        decode_method=args.decode_method, beam_size=args.beam_size,
        max_length=args.max_length, batch_size=args.batch_size,
        mel_bucket=args.mel_bucket, seed=args.seed, device=args.device,
        encoder_int8=args.encoder_int8, int8_scheme=args.int8_scheme)
    run_server(service, host=args.host, port=args.port,
               max_wait_ms=args.max_wait_ms)


if __name__ == "__main__":
    main()
