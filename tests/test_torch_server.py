"""The port's serving runtime on the CPU: the coalescing batcher
(piper_tpu_torch/server/batcher.py) against the JAX package's on the same
scripted arrivals, the batcher on a real TorchVoice, the HTTP server's
endpoints and keys, the CLI's raw output, the server's device rule, and
the voice's thread-safety repairs (parity precision's TF32 flags, the
generator of unseeded seeds, the kernels' launch counters)."""

import base64
import http.client
import io
import json
import sys
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request
import wave

import numpy as np
import pytest
import torch

from piper_tpu.server import batcher as JB
from piper_tpu_torch.config import AudioConfig, ModelConfig, SynthesisConfig
from piper_tpu_torch.models.vits import model as M
from piper_tpu_torch.ops.cuda import vocoder as V
from piper_tpu_torch.runtime import codec as TC
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.runtime.streaming import DEFAULT_CHUNK_FRAMES
from piper_tpu_torch.server import batcher as TB
from piper_tpu_torch.server.http_server import serve
from piper_tpu_torch.weights.native import save_native

# The medium preset's generator shape at narrow widths, codepoint phonemes.
CFG = ModelConfig(
    num_symbols=256, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, upsample_initial_channel=64, audio=AudioConfig(sample_rate=22050),
)
U = CFG.upsample_factor
BATCHERS = {"jax": JB, "torch": TB}


@pytest.fixture(scope="module")
def params():
    return M.init_synthesizer_params(0, CFG)


def _voice(params, precision="fast"):
    return RV.TorchVoice(params, CFG, RV.random_voice_config(CFG), precision=precision,
                         device="cpu", seed=0)


@pytest.fixture(scope="module")
def fast_voice(params):
    """fast precision (the serving one): int16 samples, so a row's audio
    is the same bits in any batch."""
    return _voice(params)


def _join(threads, timeout=120):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a request thread did not finish"


# ---------------------------------------------------------------------------
# The batcher against the JAX package's, on a stub voice
# ---------------------------------------------------------------------------


def _stub_voice(record, gate=None, fail_tag=None):
    """Voice stand-in: submit() records each batch's row tags (the first id
    of each row) once `gate` opens, and raises for one tag. `entered`
    counts the submits that have begun."""
    entered = []

    def submit(ids_list, syn=None, row_seeds=None):
        entered.append(len(ids_list))
        if gate is not None:
            gate.wait()
        record.append([ids[0] for ids in ids_list])
        if fail_tag is not None and fail_tag in record[-1]:
            raise RuntimeError("boom")
        return [np.zeros(8, np.float32) for _ in ids_list]

    return types.SimpleNamespace(
        submit=submit,
        collect=lambda handle: handle,
        entered=entered,
        config=types.SimpleNamespace(
            sample_rate=16000,
            inference=types.SimpleNamespace(noise_scale=0.667, length_scale=1.0, noise_w=0.8),
        ),
    )


def _wait_for(cond, what, timeout=60.0):
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        time.sleep(0.005)


def _arrive(batcher, threads):
    """Start request threads one by one, each after the last is queued,
    so their arrival order is the order given."""
    for t in threads:
        n = batcher._q.qsize()
        t.start()
        _wait_for(lambda: batcher._q.qsize() > n, "a request to be queued")


def _script_priority(mod):
    """While the dispatcher is held in submit, queued requests dispatch by
    priority (lower first), FIFO within a priority."""
    record, gate = [], threading.Event()
    voice = _stub_voice(record, gate)
    batcher = mod.CoalescingBatcher(voice, window_ms=1.0, max_batch=1)
    try:
        def worker(tag, prio):
            batcher.synthesize_ids_batch([[tag]], syn=SynthesisConfig(priority=prio))

        first = threading.Thread(target=worker, args=(100, 0))
        first.start()
        _wait_for(lambda: voice.entered, "submit(100)")
        later = [threading.Thread(target=worker, args=a) for a in [(101, 5), (102, 0), (103, 9), (104, 5)]]
        _arrive(batcher, later)
        gate.set()
        _join([first, *later])
    finally:
        batcher.close()
    return record, None


def _script_deadline(mod):
    """A request still queued past its deadline_s is shed before any
    device work; the one in flight completes."""
    record, gate, outcome = [], threading.Event(), {}
    voice = _stub_voice(record, gate)
    batcher = mod.CoalescingBatcher(voice, window_ms=1.0, max_batch=1)
    try:
        def worker(tag, syn):
            try:
                outcome[tag] = len(batcher.synthesize_ids_batch([[tag]], syn=syn))
            except mod.DeadlineExceeded:
                outcome[tag] = "shed"

        t1 = threading.Thread(target=worker, args=(1, SynthesisConfig()))
        t1.start()
        _wait_for(lambda: voice.entered, "submit(1)")
        t2 = threading.Thread(target=worker, args=(2, SynthesisConfig(deadline_s=0.05)))
        _arrive(batcher, [t2])
        time.sleep(0.2)  # request 2's queue-wait deadline passes
        gate.set()
        _join([t1, t2])
    finally:
        batcher.close()
    return record, (outcome, dict(batcher.stats))


def _script_close(mod):
    """close() with requests queued behind a held dispatcher: every queued
    request completes (the shutdown sentinel drains last), and a request
    after close gets 'batcher is closed'; no thread is stranded."""
    record, gate, outcome = [], threading.Event(), {}
    voice = _stub_voice(record, gate)
    batcher = mod.CoalescingBatcher(voice, window_ms=1.0, max_batch=1)

    def worker(tag):
        try:
            batcher.synthesize_ids_batch([[tag]], syn=SynthesisConfig(seed=tag))
            outcome[tag] = "ok"
        except RuntimeError as e:
            outcome[tag] = str(e)

    threads = [threading.Thread(target=worker, args=(tag,)) for tag in (1, 2, 3)]
    threads[0].start()
    _wait_for(lambda: voice.entered, "submit(1)")
    _arrive(batcher, threads[1:])
    closer = threading.Thread(target=batcher.close)
    closer.start()
    _wait_for(lambda: batcher._closed, "close()")
    worker(4)  # after close
    gate.set()
    _join([*threads, closer])
    return record, outcome


def _script_error(mod):
    """An error in submit reaches the requests of that batch only; the
    batcher serves the next request."""
    record = []
    batcher = mod.CoalescingBatcher(_stub_voice(record, fail_tag=7), window_ms=1.0, max_batch=8)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            batcher.synthesize_ids_batch([[7]], syn=SynthesisConfig())
        out = batcher.synthesize_ids_batch([[8], [9]], syn=SynthesisConfig(seed=1))
    finally:
        batcher.close()
    return record, (len(out), dict(batcher.stats))


def _script_cap(mod):
    """A request that would push a window past max_batch seeds the next
    window instead."""
    record, gate = [], threading.Event()
    voice = _stub_voice(record, gate)
    batcher = mod.CoalescingBatcher(voice, window_ms=200.0, max_batch=8)
    try:
        def worker(tag, n):
            batcher.synthesize_ids_batch([[tag]] * n, syn=SynthesisConfig(seed=1))

        threads = [threading.Thread(target=worker, args=(1, 6))]
        threads[0].start()
        _wait_for(lambda: voice.entered, "the first window's submit")
        threads += [threading.Thread(target=worker, args=a) for a in [(2, 1), (3, 1), (4, 6), (5, 2)]]
        _arrive(batcher, threads[1:])
        gate.set()
        _join(threads)
    finally:
        batcher.close()
    return record, None


@pytest.mark.parametrize("script,expected", [
    (_script_priority, ([[100], [102], [101], [104], [103]], None)),
    (_script_deadline, ([[1]], ({1: 1, 2: "shed"}, {"requests": 2, "batches": 1, "utterances": 1,
                                                    "shed_deadline": 1, "errors": 0}))),
    (_script_close, ([[1], [2], [3]], {1: "ok", 2: "ok", 3: "ok", 4: "batcher is closed"})),
    (_script_error, ([[7], [8, 9]], (2, {"requests": 2, "batches": 1, "utterances": 2,
                                         "shed_deadline": 0, "errors": 1}))),
    (_script_cap, ([[1] * 6, [2, 3] + [4] * 6, [5, 5]], None)),
], ids=["priority", "deadline", "close", "error", "cap"])
def test_batcher_dispatch_matches_jax(script, expected):
    """The same scripted arrivals through both packages' batchers give the
    same dispatch record and outcomes."""
    got = {name: script(mod) for name, mod in BATCHERS.items()}
    assert got["torch"] == got["jax"] == expected


# ---------------------------------------------------------------------------
# The batcher on a real voice
# ---------------------------------------------------------------------------


def _requests(n, seed=11):
    rng = np.random.default_rng(seed)
    return [[rng.integers(3, 256, int(rng.integers(4, 40))).tolist()] for _ in range(n)]


def _coalesce(voice, reqs, syns, window_ms=100.0, max_batch=32):
    """Each request from its own thread through a batcher; returns the
    results and the row counts of the voice's submits."""
    submits = []
    orig = voice.submit

    def counting_submit(ids_list, **kw):
        submits.append(len(ids_list))
        return orig(ids_list, **kw)

    voice.submit = counting_submit
    batcher = TB.CoalescingBatcher(voice, window_ms=window_ms, max_batch=max_batch)
    results = [None] * len(reqs)

    def worker(i):
        results[i] = batcher.synthesize_ids_batch(reqs[i], syn=syns[i])

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        voice.submit = orig
        batcher.close()
    return results, submits


@pytest.mark.parametrize("case", ["same_seed", "mixed_keys", "large_negative_seeds"])
def test_coalesced_equals_solo(fast_voice, case):
    """Coalesced rows are the solo rows' bits: one seed for all; mixed
    seeds and length scales (different synthesis keys never share a
    submit); seeds past 2^32 and negative (taken mod 2^32 everywhere)."""
    if case == "same_seed":
        reqs = _requests(8)
        syns = [SynthesisConfig(seed=5)] * 8
    elif case == "mixed_keys":
        reqs = _requests(4, seed=12)
        syns = [SynthesisConfig(seed=5, length_scale=1.0), SynthesisConfig(seed=5, length_scale=2.0),
                SynthesisConfig(seed=5, length_scale=1.0), SynthesisConfig(seed=7, length_scale=1.0)]
    else:
        reqs = _requests(2, seed=13)
        syns = [SynthesisConfig(seed=(1 << 40) + 123), SynthesisConfig(seed=-7)]
    solo = [fast_voice.synthesize_ids_batch(r, syn=s) for r, s in zip(reqs, syns)]
    results, submits = _coalesce(fast_voice, reqs, syns)
    for got, want in zip(results, solo):
        assert len(got) == len(want) == 1 and len(got[0]) > 0
        np.testing.assert_array_equal(got[0], want[0])
    assert len(submits) < len(reqs)
    if case == "mixed_keys":
        assert len(submits) == 2  # two length scales, one submit each
    if case == "large_negative_seeds":
        mod = [fast_voice.synthesize_ids_batch(r, syn=SynthesisConfig(seed=s.seed % 2**32))[0]
               for r, s in zip(reqs, syns)]
        for got, want in zip(results, mod):
            np.testing.assert_array_equal(got[0], want)


def test_submit_and_collect_split(fast_voice):
    """collect(submit(...)) on another thread is synthesize_ids_batch;
    row_seeds give each row the audio of a solo seeded submit."""
    reqs = [r[0] for r in _requests(3, seed=14)]
    want = [fast_voice.synthesize_ids_batch([r], syn=SynthesisConfig(seed=s))[0]
            for r, s in zip(reqs, (1, 2, 3))]
    handle = fast_voice.submit(reqs, row_seeds=[1, 2, 3])
    got = []
    t = threading.Thread(target=lambda: got.extend(fast_voice.collect(handle)))
    t.start()
    _join([t])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    stats = RV.SynthesisStats()
    fast_voice.collect(fast_voice.submit(reqs[:1], syn=SynthesisConfig(seed=1)), stats=stats)
    assert stats.audio_seconds == len(want[0]) / CFG.audio.sample_rate and stats.infer_seconds > 0


def test_warmup_runs_every_row_count(fast_voice):
    """warmup(full=True) encodes once per (batch size, phoneme bucket) and
    synthesises one batch per power-of-two row count up to the largest."""
    rows = []
    orig = fast_voice.submit

    def counting_submit(ids_list, **kw):
        rows.append(len(ids_list))
        return orig(ids_list, **kw)

    fast_voice.submit = counting_submit
    try:
        fast_voice.warmup((1, 6))
        assert rows == []
        fast_voice.warmup((1, 6), full=True)
    finally:
        fast_voice.submit = orig
    assert rows == [1, 2, 4, 6]


# ---------------------------------------------------------------------------
# The HTTP server
# ---------------------------------------------------------------------------


class _Server:
    def __init__(self, voice, **kw):
        self.voice = voice
        self.server = serve(voice, host="127.0.0.1", port=0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def url(self, path):
        return f"http://127.0.0.1:{self.port}{path}"

    def get(self, path, data=None, headers=None):
        req = urllib.request.Request(self.url(path), data=data, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


@pytest.fixture(scope="module")
def served(params):
    """A fast CPU voice behind the server, with the batcher on."""
    voice = _voice(params)
    voice.batcher = TB.CoalescingBatcher(voice, window_ms=4.0, max_batch=16)
    srv = _Server(voice)
    yield srv
    srv.close()
    voice.batcher.close()


def _pcm(wav):
    with wave.open(io.BytesIO(wav), "rb") as w:
        assert w.getframerate() == 22050 and w.getsampwidth() == 2 and w.getnchannels() == 1
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_http_wav_get_and_post(served):
    status, headers, body = served.get("/?text=Hello%20there.%20Second%20one.&seed=3")
    assert status == 200 and headers["Content-Type"] == "audio/wav" and float(headers["X-RTF"]) > 0
    pcm = _pcm(body)
    assert len(pcm) > 0 and np.abs(pcm).max() > 0
    text = "Hello there. Second one."
    for data, ctype in [
        (text.encode(), "text/plain"),
        (json.dumps({"text": text}).encode(), "application/json"),
        (b"text=Hello+there.+Second+one.", "application/x-www-form-urlencoded"),
    ]:
        status, _, body2 = served.get("/?seed=3", data=data, headers={"Content-Type": ctype})
        assert status == 200 and body2 == body, ctype
    # the voice alone (no server, no batcher) gives the same samples
    batcher, served.voice.batcher = served.voice.batcher, None
    try:
        alone = served.voice.synthesize(text, syn=SynthesisConfig(seed=3))
    finally:
        served.voice.batcher = batcher
    np.testing.assert_array_equal(pcm, alone)
    for path in ("/?text=%20%20", "/stream?text="):
        assert served.get(path)[0] == 400
    assert served.get("/", data=b"", headers={"Content-Type": "text/plain"})[0] == 400


def test_http_batch(served):
    texts = ["One text.", "Another, longer text to read."]
    status, _, body = served.get("/batch?seed=2", data=json.dumps({"texts": texts}).encode(),
                                 headers={"Content-Type": "application/json"})
    assert status == 200
    wavs = [_pcm(base64.b64decode(w)) for w in json.loads(body)["wavs"]]
    assert len(wavs) == 2 and all(len(w) > 0 for w in wavs)
    _, _, again = served.get("/batch?seed=2", data=json.dumps({"texts": texts[1:]}).encode(),
                             headers={"Content-Type": "application/json"})
    np.testing.assert_array_equal(_pcm(base64.b64decode(json.loads(again)["wavs"][0])), wavs[1])
    assert served.get("/batch", data=b"[1, 2]", headers={"Content-Type": "application/json"})[0] == 400


def _read_chunked(port, path):
    """GET through a raw socket; returns (headers, [chunk payloads]) after
    checking the HTTP/1.1 chunk framing byte by byte."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.putrequest("GET", path)
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("Transfer-Encoding") == "chunked"
    raw = resp.fp  # the socket's file, past the headers
    chunks = []
    while True:
        size_line = raw.readline()
        assert size_line.endswith(b"\r\n"), size_line
        size = int(size_line, 16)
        payload = raw.read(size)
        assert len(payload) == size and raw.read(2) == b"\r\n"
        if size == 0:
            break
        chunks.append(payload)
    headers = dict(resp.getheaders())
    conn.close()
    return headers, chunks


def test_http_stream_chunked(served):
    """/stream: whole chunks of 45 frames (the last shorter), the zero
    terminator, the batch path's sample count; mulaw is the s16le
    samples' G.711 codes; http.client reads the same body."""
    text = "A sentence long enough to be streamed in several chunks, " * 3
    q = urllib.parse.quote(text)
    headers, chunks = _read_chunked(served.port, f"/stream?text={q}&seed=4")
    assert headers["X-Sample-Rate"] == "22050" and headers["Content-Type"] == "audio/L16"
    pcm = np.frombuffer(b"".join(chunks), "<i2")
    assert len(chunks) >= 3 and all(len(c) == 2 * DEFAULT_CHUNK_FRAMES * U for c in chunks[:-1])
    voice = served.voice
    ids = voice.phonemes_to_ids(voice.phonemize(text.strip())[0])
    batched = voice.synthesize_ids_batch([ids], syn=SynthesisConfig(seed=4))[0]
    assert len(pcm) == len(batched)
    _, mu_chunks = _read_chunked(served.port, f"/stream?text={q}&seed=4&format=mulaw")
    assert b"".join(mu_chunks) == TC.mulaw_encode(pcm).tobytes()
    with urllib.request.urlopen(served.url(f"/stream?text={q}&seed=4"), timeout=120) as resp:
        assert resp.read() == pcm.tobytes()
    assert served.get(f"/stream?text={q}&format=flac")[0] == 400


def test_http_health_and_metrics_keys_match_jax(served):
    """/health has the JAX server's keys; /metrics has them, spec_margin
    (the speculative transfer's margin) among them, and the port's
    batches by path (`paths`)."""
    from piper_tpu.server.http_server import serve as jax_serve

    cfg = served.voice.config
    stub = types.SimpleNamespace(
        config=types.SimpleNamespace(sample_rate=cfg.sample_rate, num_speakers=cfg.num_speakers,
                                     espeak_voice=cfg.espeak_voice, speaker_id_map={}),
        precision="fast", batcher=JB.CoalescingBatcher(_stub_voice([]), window_ms=1.0),
    )
    jax_srv = _Server.__new__(_Server)
    jax_srv.voice = stub
    jax_srv.server = jax_serve(stub, host="127.0.0.1", port=0)
    jax_srv.port = jax_srv.server.server_address[1]
    jax_srv.thread = threading.Thread(target=jax_srv.server.serve_forever, daemon=True)
    jax_srv.thread.start()
    try:
        bodies = {name: {p: json.loads(s.get(p)[2]) for p in ("/health", "/metrics")}
                  for name, s in (("jax", jax_srv), ("torch", served))}
    finally:
        jax_srv.close()
        stub.batcher.close()
    assert bodies["torch"]["/health"].keys() == bodies["jax"]["/health"].keys()
    assert bodies["torch"]["/health"]["sample_rate"] == 22050
    assert bodies["torch"]["/metrics"].keys() == bodies["jax"]["/metrics"].keys() | {"paths"}
    assert 0.25 <= bodies["torch"]["/metrics"]["spec_margin"] <= 1.5  # JAX's bounds
    assert set(bodies["torch"]["/metrics"]["paths"]) == {"exact", "speculative", "fused", "refetched",
                                                         "redecoded", "longform", "fused_failed"}
    assert bodies["torch"]["/metrics"]["batcher"].keys() == bodies["jax"]["/metrics"]["batcher"].keys()


def test_http_deadline_and_stream_slots(params):
    """A request shed in the admission queue is 503 while the one in
    flight is 200; with the single stream slot held, a stream with a
    deadline is 503 and the holder completes; /metrics counts both."""
    voice = _voice(params)
    gate, entered = threading.Event(), []
    orig_submit = voice.submit

    def gated_submit(ids_list, **kw):
        entered.append(len(ids_list))
        gate.wait()
        return orig_submit(ids_list, **kw)

    voice.submit = gated_submit
    voice.batcher = TB.CoalescingBatcher(voice, window_ms=1.0, max_batch=1)
    srv = _Server(voice, stream_max_concurrent=1)
    try:
        status = {}

        def client(tag, path):
            status[tag] = srv.get(path)[0]

        t0 = threading.Thread(target=client, args=("ok", "/?text=hello%20there.&seed=1"))
        t0.start()
        _wait_for(lambda: entered, "the first request to hold the gated dispatcher")
        t1 = threading.Thread(target=client, args=("late", "/?text=hello%20there.&seed=2&deadline_ms=50"))
        t1.start()
        _wait_for(lambda: voice.batcher._q.qsize() == 1, "the late request to be queued")
        time.sleep(0.2)  # its queue-wait deadline passes
        gate.set()
        _join([t0, t1])
        assert status == {"ok": 200, "late": 503}

        calls, slot_gate = [], threading.Event()
        orig_phonemize = voice.phonemize

        def gated_phonemize(text):  # runs once the stream holds its slot
            calls.append(text)
            if len(calls) == 1:
                slot_gate.wait()
            return orig_phonemize(text)

        voice.phonemize = gated_phonemize
        t2 = threading.Thread(target=client, args=("holder", "/stream?text=slot%20test.&seed=1"))
        t2.start()
        for _ in range(100):
            if calls:
                break
            time.sleep(0.05)
        assert calls, "the first stream never started"
        client("shed", "/stream?text=slot%20test.&seed=2&deadline_ms=100")
        slot_gate.set()
        _join([t2])
        assert status["shed"] == 503 and status["holder"] == 200
        m = json.loads(srv.get("/metrics")[2])
        assert (m["wav_requests"], m["wav_shed_deadline"], m["streams_served"], m["streams_shed"],
                m["streams_active"]) == (2, 1, 1, 1, 0)
        assert m["batcher"]["shed_deadline"] == 1
    finally:
        srv.close()
        voice.batcher.close()


# ---------------------------------------------------------------------------
# The CLI and the server's entry point
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def voice_file(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("voice")
    save_native(str(d / "voice.npz"), params, CFG)
    (d / "voice.npz.json").write_text(json.dumps(RV.random_voice_config(CFG).to_dict()))
    return d / "voice.npz"


def test_cli_output_raw_is_the_wav_pcm(voice_file, monkeypatch, tmp_path):
    from piper_tpu_torch.__main__ import main

    text = "Raw output test. Two sentences.\n"
    base = ["-m", str(voice_file), "--device", "cpu", "--seed", "2", "-q"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    main(base + ["-f", str(tmp_path / "a.wav")])
    pcm = _pcm((tmp_path / "a.wav").read_bytes())
    raw = {}
    for fmt in TC.RAW_FORMATS:
        out = io.TextIOWrapper(io.BytesIO())
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        monkeypatch.setattr(sys, "stdout", out)
        main(base + ["--output-raw", "--raw-format", fmt])
        raw[fmt] = out.buffer.getvalue()
    assert raw["s16le"] == pcm.tobytes()
    assert raw["mulaw"] == TC.mulaw_encode(pcm).tobytes()


def test_server_main_needs_cuda_unless_told(voice_file, monkeypatch):
    from piper_tpu_torch.server.http_server import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-m", str(voice_file), "--port", "0", "--warmup", "off"])


# ---------------------------------------------------------------------------
# Thread-safety repairs
# ---------------------------------------------------------------------------


def _in_threads(n, fn):
    """fn(i) on n threads released together; returns the results."""
    barrier, out = threading.Barrier(n), [None] * n

    def run(i):
        barrier.wait()
        out[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(old)
    return out


def test_voice_build_turns_tf32_off_for_every_thread(params, monkeypatch):
    """Building a voice switches TF32 off for the process, once: 8 parity
    requests at once each compute with TF32 off for their whole generator,
    no call switches the flags, and each gives the bytes it gives alone."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    voice = _voice(params, "parity")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)
    reqs = [r[0] for r in _requests(8, seed=21)]
    serial = [voice.synthesize_ids_batch([r], syn=SynthesisConfig(seed=i))[0]
              for i, r in enumerate(reqs)]
    seen = []
    vocode = voice._vocode  # a decode: frame windows, then the generator's kernels

    def observing_vocode(*a, **k):
        before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        out = vocode(*a, **k)
        seen.append((before, (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
        return out

    monkeypatch.setattr(voice, "_vocode", observing_vocode)
    got = _in_threads(8, lambda i: voice.synthesize_ids_batch([reqs[i]], syn=SynthesisConfig(seed=i))[0])
    assert len(seen) == 8 and all(s == ((False, False), (False, False)) for s in seen), seen
    for g, s in zip(got, serial):
        assert g.tobytes() == s.tobytes()


class _RacyGenerator:
    """A seed generator whose draw is an unguarded read-modify-write with
    a thread switch in the middle: two callers at once get the same
    seeds unless the voice serialises its draws."""

    def __init__(self):
        self.next = 0

    def integers(self, low, high, size):
        start = self.next
        time.sleep(0.002)
        self.next = start + size
        return np.arange(start, start + size, dtype=np.int64)


def test_unseeded_requests_draw_distinct_seeds(params):
    """8 unseeded requests at once each draw their own seeds from the
    voice's generator: no seed is handed out twice."""
    voice = _voice(params)
    voice._rng = _RacyGenerator()
    drawn = []
    seed = RV.utterance_seed

    def recording_seed(s, ids):
        drawn.append(s)
        return seed(s, ids)

    ids = [[1, 0, 40, 0, 41, 0, 2]] * 2
    orig = RV.utterance_seed
    RV.utterance_seed = recording_seed
    try:
        _in_threads(8, lambda i: voice.synthesize_ids_batch(ids, syn=SynthesisConfig()))
    finally:
        RV.utterance_seed = orig
    assert sorted(drawn) == list(range(16))


def test_launch_counts_are_exact_under_threads():
    """The wrappers count launches through count_launch, which loses no
    update when many threads launch at once."""
    import inspect

    for wrapper in (V.mrf_fused, V.fused_upsample_mrf):
        src = inspect.getsource(wrapper)
        assert f"count_launch({wrapper.__name__})" in src and "launches +=" not in src
    saved = V.mrf_fused.launches
    V.mrf_fused.launches = 0
    try:
        _in_threads(8, lambda i: [V.count_launch(V.mrf_fused) for _ in range(20000)])
        assert V.mrf_fused.launches == 8 * 20000
    finally:
        V.mrf_fused.launches = saved


def test_bf16_frame_lengths_are_exact_past_256(fast_voice, monkeypatch):
    """fast precision: the generator gets each row's exact frame count.
    Summed as a bfloat16 mask, 259 and 261 frames both came out as 260,
    so a row decoded inside a longer batch read one frame of padding and
    differed from the same row alone in its last frames."""
    from piper_tpu_torch.models.vits import generator as G

    seen = []

    class Stop(Exception):
        pass

    def spy(p, tm, x, frame_lengths, **kw):
        seen.append(frame_lengths.tolist())
        raise Stop

    monkeypatch.setattr(G, "generator_tm_apply", spy)
    lengths = [259, 261, 300]
    y_mask = (torch.arange(300)[None, :, None] < torch.tensor(lengths)[:, None, None]).to(torch.bfloat16)
    z_p = torch.zeros((3, 300, CFG.inter_channels), dtype=torch.bfloat16)
    with pytest.raises(Stop), torch.inference_mode():
        M.synthesizer_vocode(fast_voice.params, z_p, y_mask, cfg=CFG)
    assert seen == [lengths]


def test_http_burst_is_not_dropped_by_the_listen_backlog(served):
    """64 clients connecting at once are all accepted at once. With
    socketserver's backlog of 5 the kernel dropped the rest of the burst's
    connection requests and each client retried a second later, then
    two, then four."""
    assert served.get("/health")[0] == 200  # the first request imports what the rest use
    barrier, lat = threading.Barrier(64), []

    def client():
        barrier.wait()
        t0 = time.perf_counter()
        assert served.get("/health")[0] == 200
        lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client) for _ in range(64)]
    for t in threads:
        t.start()
    _join(threads)
    assert len(lat) == 64 and max(lat) < 0.9, sorted(lat)[-5:]  # the first retry comes after 1 s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_by_row_transposed_conv_is_each_row_alone(fast_voice, dtype):
    """The batch path's stage-0 transposed conv gives each row exactly
    what the row alone at its own length gives, and zeros past it: on the
    card one product over the batch rounds rows by the batch's shape
    (chip_smoke.py holds coalesced rows to solo rows bit for bit)."""
    from piper_tpu_torch.models.vits import generator as G

    tm = fast_voice.params["dec_tm"]
    k, u = CFG.upsample_kernel_sizes[0], CFG.upsample_rates[0]
    q0, used, _ = G._tm_phase_plan(k, u)
    w, bias = tm["ups"][0].to(dtype), tm["ups_b"][0]
    lengths = [37, 30, 3]
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, w.shape[2], 37), generator=g).to(dtype)
    got = G._tconv_tm_rows(x, w, q0, used, bias, lengths)
    for r, n in enumerate(lengths):
        alone = G._tconv_tm(x[r : r + 1, :, :n].contiguous(), w, q0, used, bias)[0]
        assert torch.equal(got[r, :, : n * u], alone)
        assert not got[r, :, n * u :].any()


@pytest.mark.parametrize("start", [1, 2])
def test_wide_stages_run_row_by_row(monkeypatch, start):
    """Stages too wide for mrf_fused's tile (the high preset's first two)
    run through cuDNN one row at a time (_nwc_stage_rows). Forced here at
    narrow widths: the time-major generator matches the JAX package's
    generator_apply on ragged rows (float32), and each row of the batch
    stage is the row alone at its own length, with zeros past it."""
    import jax
    import jax.numpy as jnp

    from piper_tpu.models.vits import generator as JG
    from piper_tpu_torch.models.vits import generator as G
    from piper_tpu_torch.weights.bridge import params_from_jax
    from torch_parity import TINY, close, jax_params, mask_np, normal, tcfg

    monkeypatch.setattr(G, "tm_start_stage", lambda cfg: start)
    tree = jax_params(TINY, 4)
    cfg = tcfg(TINY)
    dec = params_from_jax(tree, cfg, "cpu", torch.float32)["dec"]
    lens = np.array([29, 21, 4], np.int32)
    m = mask_np(lens, 29)
    z = normal(np.random.default_rng(5), (3, 29, TINY.inter_channels)) * m
    got = G.generator_tm_apply(dec, G.prepare_tm(dec, cfg, torch.float32), torch.from_numpy(z),
                               torch.from_numpy(lens), cfg=cfg)
    ref = JG.generator_apply(jax.tree.map(jnp.asarray, tree["dec"]), jnp.asarray(z), jnp.asarray(m), cfg=TINY)
    u = cfg.upsample_factor
    for i, n in enumerate(lens):
        close(got[i, : n * u], np.asarray(ref)[i, : n * u], what=f"row {i} vs JAX generator_apply")

    x = torch.from_numpy(normal(np.random.default_rng(6), (3, 29, cfg.upsample_initial_channel)))
    rows = G._nwc_stage_rows(dec, 0, x, list(lens), cfg)
    u0 = cfg.upsample_rates[0]
    for r, n in enumerate(lens):
        alone = G._nwc_stage_rows(dec, 0, x[r : r + 1, :n], [int(n)], cfg)[0]
        assert torch.equal(rows[r, : n * u0], alone)
        assert not rows[r, n * u0 :].any()
