"""HTTP serving of mixing style transfer, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/serve.py``: a stdlib HTTP
server around a warm :class:`StyleTransferEngine` (the reference ships no
serving layer). Models stay resident on the card across requests, and the
hand-written kernels are built once, at the first request that runs them
(or at ``/warmup``), not per song.

Endpoints (JSON over POST unless noted):

- ``GET  /health``      -> {"status": "ok", "backend": <device type>,
                           "requests": N, "busy": bool, "queue_depth": N,
                           "max_queue": N}
- ``POST /transfer``    -> body {"target_dir": ..., "output_dir": ...,
                           optional "interpolation": bool}
                           runs the directory pipeline, returns written paths
- ``POST /embed``       -> body {"wav": path, "segment_length": int?}
                           returns the 2048-D FX embedding
- ``POST /warmup``      -> body {"seconds": float?} runs the request path on
                           a synthetic song of that length twice (the first
                           run builds the kernels); returns
                           {"cold_s": ..., "warm_s": ...}
                           (also at startup with --warmup_seconds N)

Admission: one request computes at a time (one card; the engine's forward
passes also set process-wide TF32 flags, so two must never overlap); up to
--max_queue more wait in FIFO order; beyond that /transfer and /embed get
429 + Retry-After. /warmup only runs when the service is idle (409
otherwise), so it never blocks live traffic.

Run:  python -m music_mixing_style_transfer_tpu_torch.serve --port 8700 \
          [--ckpt_path_enc ... --ckpt_path_conv ... --dtype bfloat16] \
          [--inference_device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .config import InferenceConfig
from .data.wavio import read_wav_stereo_ct, read_wav_stereo_ct_i16
from .infer.pipeline import MixingStyleTransfer, StyleTransferEngine
from .utils.logging import get_logger

log = get_logger("serve")

NOT_PORTED = "not yet ported to the PyTorch package (ROADMAP A6: multi-GPU inference)"


class QueueFullError(Exception):
    """Admission queue at capacity: HTTP 429."""


class ServiceBusyError(Exception):
    """An admission-aware endpoint declined to queue: HTTP 409."""


class AdmissionQueue:
    """Bounded FIFO admission to the card: one request computes at a time,
    and the queue behind it is visible and bounded.

    ``acquire()`` joins the queue, or raises :class:`QueueFullError` when
    ``max_queue`` requests already wait; ``acquire_if_idle()`` proceeds only
    when nothing is queued or running. ``snapshot()`` feeds ``/health``.

    FIFO comes from admission tickets: each ``acquire`` takes the next
    ticket and waits on a :class:`threading.Condition` until the serving
    counter reaches it (a bare ``Lock`` gives no wake-up order)."""

    def __init__(self, max_queue: int = 4):
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._admitted = 0     # running (<= 1) + waiting
        self._next_ticket = 0  # next ticket to hand out
        self._serving = 0      # ticket allowed on the card

    def acquire(self) -> None:
        with self._cond:
            if self._admitted > self.max_queue:  # 1 running + max_queue waiting
                raise QueueFullError(f"queue full ({self.max_queue} waiting); retry later")
            self._admitted += 1
            ticket = self._next_ticket
            self._next_ticket += 1
            while ticket != self._serving:
                self._cond.wait()

    def acquire_if_idle(self) -> None:
        with self._cond:
            if self._admitted > 0:
                raise ServiceBusyError("requests in flight; warmup declined")
            self._admitted += 1
            self._next_ticket += 1  # idle: this ticket is the one serving

    def release(self) -> None:
        with self._cond:
            self._serving += 1
            self._admitted -= 1
            self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "busy": self._admitted > 0,
                "queue_depth": max(self._admitted - 1, 0),
                "max_queue": self.max_queue,
            }


class StyleTransferService:
    """Warm engine + optional normalizer behind bounded FIFO admission.
    Every method that computes holds the admission slot while it does."""

    def __init__(
        self,
        engine: StyleTransferEngine,
        inference_cfg: Optional[InferenceConfig] = None,
        normalizer=None,
        max_queue: int = 4,
    ):
        self.engine = engine
        self.cfg = inference_cfg or InferenceConfig()
        self.normalizer = normalizer
        self.admission = AdmissionQueue(max_queue)
        self.requests = 0

    def transfer(self, target_dir: str, output_dir: Optional[str] = None, interpolation: bool = False):
        self.admission.acquire()
        try:
            self.requests += 1
            cfg = dataclasses.replace(self.cfg, interpolation=interpolation)
            pipeline = MixingStyleTransfer(self.engine, cfg, normalizer=self.normalizer)
            return pipeline.run_directory(target_dir, output_dir)
        finally:
            self.admission.release()

    def warmup(self, seconds: float = 30.0):
        """Run the request path (PCM stem stacks through
        ``transfer_song_pcm``, then an embedding) on a synthetic song of
        ``seconds`` twice, before traffic, and return both wall times. The
        first run pays the one-time costs: the kernels' builds, cuDNN's
        algorithm choice, the allocator's first blocks."""
        self.admission.acquire_if_idle()
        try:
            cfg = self.cfg
            pipeline = MixingStyleTransfer(self.engine, cfg, normalizer=self.normalizer)
            rng = np.random.default_rng(0)
            S = len(cfg.instruments)
            T = int(seconds * cfg.sample_rate)

            def pcm():
                return (rng.standard_normal((S, 2, T)) * 4000).astype(np.int16)

            out = {"seconds": seconds}
            for key in ("cold_s", "warm_s"):
                t0 = time.perf_counter()
                mix, _ = pipeline.transfer_song_pcm(pcm(), pcm())
                self.engine.embed_song(pcm()[0].astype(np.float32) / 32768.0, cfg.segment_length_ref)
                if mix.shape != (2, T):
                    raise RuntimeError(f"warmup: mixture of shape {mix.shape}, expected {(2, T)}")
                out[key] = round(time.perf_counter() - t0, 3)
            log.info("warmup(%.1fs song): cold %.2fs, warm %.2fs", seconds, out["cold_s"], out["warm_s"])
            return out
        finally:
            self.admission.release()

    def embed(self, wav_path: str, segment_length: Optional[int] = None):
        self.admission.acquire()
        try:
            self.requests += 1
            try:
                # 16-bit PCM uploads int16 and is dequantized on the device
                audio = read_wav_stereo_ct_i16(wav_path, expected_rate=self.cfg.sample_rate)
            except ValueError:
                audio = read_wav_stereo_ct(wav_path, expected_rate=self.cfg.sample_rate)
            emb = self.engine.embed_song(audio, segment_length or self.cfg.segment_length_ref)
            return np.asarray(emb).tolist()
        finally:
            self.admission.release()


def make_handler(service: StyleTransferService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            log.info("%s %s", self.address_string(), fmt % args)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {
                    "status": "ok",
                    "backend": service.engine.device.type,
                    "requests": service.requests,
                    **service.admission.snapshot(),
                })
            else:
                self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/transfer":
                    written = service.transfer(
                        req["target_dir"], req.get("output_dir"), bool(req.get("interpolation", False))
                    )
                    self._send(200, {"written": written})
                elif self.path == "/embed":
                    self._send(200, {"embedding": service.embed(req["wav"], req.get("segment_length"))})
                elif self.path == "/warmup":
                    self._send(200, service.warmup(float(req.get("seconds", 30.0))))
                else:
                    self._send(404, {"error": "unknown endpoint"})
            except QueueFullError as e:
                self._send(429, {"error": str(e), **service.admission.snapshot()},
                           headers=[("Retry-After", "30")])
            except ServiceBusyError as e:
                self._send(409, {"error": str(e), **service.admission.snapshot()})
            except Exception as e:  # the server keeps serving; the failure is logged and returned
                log.exception("request failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(service: StyleTransferService, port: int = 8700, host: str = "127.0.0.1"):
    """A ``ThreadingHTTPServer`` bound to ``(host, port)`` (port 0: any
    free one); the caller runs ``serve_forever`` and ``shutdown``."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    log.info("serving on http://%s:%d", host, httpd.server_address[1])
    return httpd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--ckpt_path_enc", type=str, default=None)
    p.add_argument("--ckpt_path_conv", type=str, default=None)
    p.add_argument("--precomputed_normalization_feature", type=str, default=None)
    p.add_argument("--normalize_input", action="store_true")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--segment_halo", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="shard the segment batch over N cards; " + NOT_PORTED)
    p.add_argument("--sequence_parallel", action="store_true",
                   help="convert each whole stem in one time-sharded forward; " + NOT_PORTED)
    p.add_argument("--max_queue", type=int, default=4,
                   help="requests allowed to WAIT behind the one computing; beyond "
                   "this /transfer and /embed return 429 with Retry-After")
    p.add_argument("--warmup_seconds", type=float, default=0.0,
                   help="run the request path on a synthetic song of this length "
                   "before accepting traffic (0 = off); also POST /warmup {\"seconds\": N}")
    p.add_argument("--inference_device", type=str, default="cuda",
                   help="torch device for the networks: cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.data_parallel > 1:
        raise NotImplementedError(f"--data_parallel {args.data_parallel}: {NOT_PORTED}")
    if args.sequence_parallel:
        raise NotImplementedError(f"--sequence_parallel: {NOT_PORTED}")

    engine = StyleTransferEngine(
        ckpt_path_enc=args.ckpt_path_enc, ckpt_path_conv=args.ckpt_path_conv,
        dtype=args.dtype, device=args.inference_device,
    )
    normalizer = None
    if args.normalize_input and args.precomputed_normalization_feature:
        from .normalize import AudioEffectsNormalizer

        normalizer = AudioEffectsNormalizer(
            args.precomputed_normalization_feature, device=args.inference_device
        )
    cfg = InferenceConfig(
        do_not_separate=True, normalize_input=normalizer is not None, dtype=args.dtype,
        segment_halo=args.segment_halo,
    )
    service = StyleTransferService(engine, cfg, normalizer, max_queue=args.max_queue)
    if args.warmup_seconds > 0:
        log.info("warming up (%.1fs synthetic song) before accepting traffic", args.warmup_seconds)
        service.warmup(args.warmup_seconds)
    serve(service, args.port, args.host).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
