"""HTTP TTS server of the port (counterpart of piper_tpu/server/http_server.py).

As the reference Flask server (src/python_run/piper/http_server.py:17-127):
GET or POST `/` with `text` (query parameter, form body, or raw/JSON
body) returns a WAV, with the real-time factor in `X-RTF`. Optional
query parameters: speaker_id (or speaker), length_scale, noise_scale,
noise_w, sentence_silence, seed, and for the admission queue priority
and deadline_ms; a parameter that does not parse, or a speaker_id the
voice does not have, is answered with 400.

Endpoints beyond the reference:
  POST /batch  - JSON {"texts": [...]} -> JSON {"wavs": [base64 WAV, ...]}
  GET  /stream - chunked raw audio as it is decoded (45-frame vocoder
                 chunks, runtime/streaming.py), HTTP/1.1 chunked
                 framing; `format=s16le` (default) or `format=mulaw`;
                 the rate in `X-Sample-Rate`
  GET  /health - liveness and voice metadata
  GET  /metrics - serving counters (requests, shed deadlines, streams,
                 the coalescing batcher's batch and utterance totals)

Built on the standard library's ThreadingHTTPServer: one thread per
connection, all launching onto the card's current stream. With the
batcher on (--batch-window-ms > 0) concurrent WAV requests share device
batches. Runs on CUDA unless --device cpu is given; without a GPU it
raises rather than falling back to the CPU.

    python -m piper_tpu_torch.server.http_server -m voice.npz --port 5000
    curl -s 'http://127.0.0.1:5000/stream?text=Hello.&seed=1' > out.raw
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..config import SynthesisConfig
from ..runtime.codec import RAW_FORMATS, encode_chunk
from ..runtime.streaming import synthesize_stream_chunks
from ..runtime.voice import SynthesisStats, TorchVoice
from ..runtime.wav import audio_float_to_int16, wav_bytes
from .batcher import DeadlineExceeded

_LOGGER = logging.getLogger("piper_tpu_torch.http_server")


def make_handler(
    voice: TorchVoice,
    default_syn: SynthesisConfig,
    stream_slots: Optional[threading.BoundedSemaphore] = None,
):
    # Server-level gauges and counters, read by GET /metrics. Request
    # threads update them, so every read-modify-write takes the lock.
    metrics = {
        "started_monotonic": time.monotonic(),
        "wav_requests": 0,
        "wav_shed_deadline": 0,
        "streams_served": 0,
        "streams_active": 0,
        "streams_shed": 0,
    }
    metrics_lock = threading.Lock()

    def bump(key: str, delta: int = 1) -> None:
        with metrics_lock:
            metrics[key] += delta

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked /stream needs 1.1

        def log_message(self, fmt, *args):
            _LOGGER.debug(fmt, *args)

        def _send(self, status: int, ctype: str, payload: bytes, headers=()):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def _syn_from_query(self, query) -> SynthesisConfig:
            syn = SynthesisConfig(**{**default_syn.__dict__})
            if "speaker_id" in query:
                syn.speaker_id = int(query["speaker_id"][0])
            if "speaker" in query and voice.config.speaker_id_map:
                syn.speaker_id = voice.config.speaker_id_map.get(
                    query["speaker"][0], syn.speaker_id
                )
            for k in ("length_scale", "noise_scale", "noise_w"):
                if k in query:
                    setattr(syn, k, float(query[k][0]))
            if "sentence_silence" in query:
                syn.sentence_silence_seconds = float(query["sentence_silence"][0])
            if "seed" in query:
                syn.seed = int(query["seed"][0])
            # admission-queue controls (with the batcher on; lower
            # priority dispatches sooner)
            if "priority" in query:
                syn.priority = int(query["priority"][0])
            if "deadline_ms" in query:
                syn.deadline_s = float(query["deadline_ms"][0]) / 1000.0
            voice.speaker_id(syn)  # raises for a speaker the voice lacks
            return syn

        def _request_syn(self, query) -> Optional[SynthesisConfig]:
            """The request's SynthesisConfig, or None after answering 400
            for a parameter that does not parse or a speaker out of range."""
            try:
                return self._syn_from_query(query)
            except ValueError as e:
                self.send_error(400, str(e))
                return None

        def _respond_wav(self, text: str, syn: SynthesisConfig):
            if not text.strip():
                self.send_error(400, "no text provided")
                return
            stats = SynthesisStats()
            bump("wav_requests")
            try:
                audio = voice.synthesize(text.strip(), syn=syn, stats=stats)
            except DeadlineExceeded as e:
                bump("wav_shed_deadline")
                self.send_error(503, str(e))
                return
            self._send(200, "audio/wav", wav_bytes(audio, voice.config.sample_rate),
                       [("X-RTF", f"{stats.real_time_factor:.5f}")])

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            query = urllib.parse.parse_qs(parsed.query)
            if parsed.path == "/stream":
                self._stream(query)
            elif parsed.path == "/metrics":
                with metrics_lock:
                    body = dict(metrics)
                body["uptime_s"] = round(time.monotonic() - body.pop("started_monotonic"), 3)
                body["batcher"] = dict(voice.batcher.stats) if voice.batcher is not None else None
                self._send(200, "application/json", json.dumps(body).encode())
            elif parsed.path == "/health":
                body = {
                    "status": "ok",
                    "sample_rate": voice.config.sample_rate,
                    "num_speakers": voice.config.num_speakers,
                    "espeak_voice": voice.config.espeak_voice,
                    "precision": voice.precision,
                }
                self._send(200, "application/json", json.dumps(body).encode())
            else:
                syn = self._request_syn(query)
                if syn is not None:
                    self._respond_wav(query.get("text", [""])[0], syn)

        def _stream(self, query):
            text = query.get("text", [""])[0]
            if not text.strip():
                self.send_error(400, "no text provided")
                return
            syn = self._request_syn(query)
            if syn is None:
                return
            fmt = query.get("format", ["s16le"])[0]
            if fmt not in RAW_FORMATS:
                self.send_error(400, f"unknown format {fmt!r} (one of {RAW_FORMATS})")
                return
            # Admission: each stream holds a decode slot for its whole
            # life (it takes the card in 45-frame chunks), so unbounded
            # concurrent streams would stretch every client's time to
            # first chunk. The wait is bounded by the request's deadline
            # (503 when it passes); without one it waits for a slot.
            if stream_slots is not None and not stream_slots.acquire(timeout=syn.deadline_s):
                bump("streams_shed")
                self.send_error(503, f"stream shed: no decode slot within deadline_s={syn.deadline_s}")
                return
            bump("streams_active")
            try:
                self._stream_body(text, syn, fmt)
                bump("streams_served")
            finally:
                bump("streams_active", -1)
                if stream_slots is not None:
                    stream_slots.release()

        def _stream_body(self, text: str, syn: SynthesisConfig, fmt: str):
            self.send_response(200)
            self.send_header("Content-Type", "audio/L16" if fmt == "s16le" else "audio/x-mulaw")
            self.send_header("X-Sample-Rate", str(voice.config.sample_rate))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for sentence in voice.phonemize(text.strip()):
                    ids = voice.phonemes_to_ids(sentence)
                    for chunk in synthesize_stream_chunks(voice, ids, syn=syn):
                        # fixed scaling: the global peak is unknown mid-stream
                        pcm = encode_chunk(chunk, fmt)
                        self.wfile.write(f"{len(pcm):X}\r\n".encode() + pcm + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                pass

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            query = urllib.parse.parse_qs(parsed.query)

            if parsed.path == "/batch":
                try:
                    texts = json.loads(body)["texts"]
                except (json.JSONDecodeError, KeyError, TypeError):
                    self.send_error(400, "expected JSON {'texts': [...]}")
                    return
                ids_list = []
                for text in texts:
                    ids = []
                    for sentence in voice.phonemize(text):
                        ids.extend(voice.phonemes_to_ids(sentence))
                    ids_list.append(ids)
                syn = self._request_syn(query)
                if syn is None:
                    return
                batch_fn = (
                    voice.batcher.synthesize_ids_batch
                    if voice.batcher is not None
                    else voice.synthesize_ids_batch
                )
                try:
                    audios = batch_fn(ids_list, syn=syn)
                except DeadlineExceeded as e:
                    self.send_error(503, str(e))
                    return
                wavs = [
                    base64.b64encode(
                        wav_bytes(audio_float_to_int16(a), voice.config.sample_rate)
                    ).decode()
                    for a in audios
                ]
                self._send(200, "application/json", json.dumps({"wavs": wavs}).encode())
                return

            if "application/json" in ctype:
                try:
                    text = json.loads(body).get("text", "")
                except (json.JSONDecodeError, AttributeError):
                    text = ""
            elif "application/x-www-form-urlencoded" in ctype:
                text = urllib.parse.parse_qs(body.decode("utf-8")).get("text", [""])[0]
            else:
                text = body.decode("utf-8")
            text = query.get("text", [text])[0]
            syn = self._request_syn(query)
            if syn is not None:
                self._respond_wav(text, syn)

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of more clients
    # overflows it, the kernel drops their connection requests, and each
    # client retries a second later (then two, then four).
    request_queue_size = 128


def serve(
    voice: TorchVoice,
    host: str = "0.0.0.0",
    port: int = 5000,
    syn: Optional[SynthesisConfig] = None,
    stream_max_concurrent: int = 4,
) -> ThreadingHTTPServer:
    """A bound server (call serve_forever() on it; port 0 picks a free one)."""
    stream_slots = (
        threading.BoundedSemaphore(stream_max_concurrent) if stream_max_concurrent > 0 else None
    )
    server = _Server((host, port), make_handler(voice, syn or SynthesisConfig(), stream_slots))
    _LOGGER.info("Serving on http://%s:%s", host, server.server_address[1])
    return server


def main(argv=None):
    from ..__main__ import build_parser, load_voice

    parser = build_parser()
    parser.prog = "piper_tpu_torch.server.http_server"
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument(
        "--warmup", choices=["off", "encode", "full", "background"], default="background",
        help="Warm the serving path before requests pay for it (TorchVoice.warmup): "
        "'encode' builds the kernels and captures the CUDA graphs of each phoneme "
        "bucket's encode (at its one row count, 16) and of the streamed chunk; "
        "'full' also captures the flow graph of every frame bucket (at its one "
        "row count), and synthesises one "
        "batch per power-of-two row count; 'background' (default) binds the port "
        "at once and runs 'full' on a daemon thread",
    )
    parser.add_argument("--warmup-batch-sizes", default="1,8",
                        help="Comma-separated batch sizes to warm (see --warmup)")
    parser.add_argument(
        "--batch-window-ms", type=float, default=4.0,
        help="Cross-request coalescing window: concurrent requests arriving "
        "within it share one device batch (0 disables; default 4 ms)",
    )
    parser.add_argument("--batch-max", type=int, default=None,
                        help="Utterance cap per coalesced batch (default: the largest warmed batch size)")
    parser.add_argument(
        "--stream-max-concurrent", type=int, default=4,
        help="Decode slots for concurrent /stream requests; excess streams wait "
        "for a slot, bounded by their deadline_ms (0 = no cap)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    # one decode per phoneme bucket of a coalesced batch (the JAX
    # server's default, piper_tpu/server/http_server.py:367-368)
    if args.decode_grouping is None:
        args.decode_grouping = "uniform"
    voice = load_voice(args)
    sizes = tuple(int(s) for s in args.warmup_batch_sizes.split(",") if s)
    if args.batch_window_ms > 0:
        from .batcher import CoalescingBatcher

        voice.batcher = CoalescingBatcher(
            voice, window_ms=args.batch_window_ms, max_batch=args.batch_max or max(sizes)
        )

    def warm(kind):
        t0 = time.perf_counter()
        voice.warmup(sizes, full=kind in ("full", "background"))
        _LOGGER.info("warmup(%s, batch_sizes=%s) in %.1fs", kind, sizes, time.perf_counter() - t0)

    if args.warmup in ("encode", "full"):
        warm(args.warmup)
    elif args.warmup == "background":
        threading.Thread(target=warm, args=("background",), daemon=True,
                         name="piper-torch-warmup").start()
    syn = SynthesisConfig(
        speaker_id=args.speaker,
        length_scale=args.length_scale,
        noise_scale=args.noise_scale,
        noise_w=args.noise_w,
        sentence_silence_seconds=args.sentence_silence,
        seed=args.seed,
    )
    server = serve(voice, args.host, args.port, syn, stream_max_concurrent=args.stream_max_concurrent)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if voice.batcher is not None:
            voice.batcher.close()


if __name__ == "__main__":
    main()
