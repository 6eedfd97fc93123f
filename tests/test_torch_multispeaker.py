"""Multi-speaker voices in the port, on the CPU: the trained two-speaker
x-low voice (tests/data/voice_xlow_ms2_trained_fp16.npz) loaded through
TorchVoice.load with a JSON sidecar, served with the coalescing batcher:
concurrent GETs that alternate speaker_id (and name speakers through the
sidecar's speaker_id_map) each equal the request served alone, and the
two speakers differ. A speaker the voice does not have is refused on the
host (ValueError, HTTP 400): on the card an embedding row out of range
is a device-side assert that ends the process's CUDA context."""

import io
import json
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest

from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config
from piper_tpu_torch.server.batcher import CoalescingBatcher
from piper_tpu_torch.server.http_server import serve
from piper_tpu_torch.weights.native import load_native

VOICE = Path(__file__).parent / "data" / "voice_xlow_ms2_trained_fp16.npz"
TEXTS = ["Two speakers, one batch.", "Hello there."]


@pytest.fixture(scope="module")
def voice_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("ms2")
    path = d / "voice.npz"
    path.symlink_to(VOICE)
    _, cfg = load_native(str(VOICE))
    sidecar = random_voice_config(cfg).to_dict()
    sidecar["speaker_id_map"] = {"alice": 0, "bob": 1}
    (d / "voice.npz.json").write_text(json.dumps(sidecar))
    return path


@pytest.fixture(scope="module")
def served(voice_path):
    voice = TorchVoice.load(voice_path, device="cpu", precision="fast", seed=0)
    assert voice.model_cfg.num_speakers == 2 and voice.config.num_speakers == 2
    voice.batcher = CoalescingBatcher(voice, window_ms=50.0, max_batch=16)
    server = serve(voice, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield voice, server.server_address[1]
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    voice.batcher.close()


def _get(port, query, path="/"):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}?{query}", timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _pcm(wav):
    with wave.open(io.BytesIO(wav), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_coalesced_speakers_equal_solo(served):
    """8 GETs from 4 clients at once, alternating speaker 0 and 1: the
    batcher coalesces each speaker's requests (a batch never mixes
    speakers: they are a device-relevant key), and every response is
    the request served alone."""
    voice, port = served
    queries = [f"text={urllib.parse.quote(TEXTS[i % 2])}&seed={i}&speaker_id={i % 2}"
               for i in range(8)]
    submits, submit = [], voice.submit

    def spying_submit(ids_list, **kw):
        submits.append((len(ids_list), kw["syn"].speaker_id))
        return submit(ids_list, **kw)

    batcher, voice.batcher = voice.batcher, None
    try:
        alone = [voice.synthesize(TEXTS[i % 2], syn=SynthesisConfig(seed=i, speaker_id=i % 2))
                 for i in range(8)]
    finally:
        voice.batcher = batcher
    got = [None] * 8
    barrier = threading.Barrier(4)

    def client(c):
        barrier.wait()
        for i in range(c, 8, 4):
            got[i] = _get(port, queries[i])

    voice.submit = spying_submit
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        voice.submit = submit
    assert not any(t.is_alive() for t in threads)
    assert all(g[0] == 200 for g in got)
    for i, (status, body) in enumerate(got):
        np.testing.assert_array_equal(_pcm(body), alone[i], err_msg=f"request {i}")
    assert len(submits) < 8 and sum(n for n, _ in submits) == 8  # coalesced
    # the same text and seed under the two speakers: different audio
    a, b = (voice.synthesize(TEXTS[0], syn=SynthesisConfig(seed=5, speaker_id=s)) for s in (0, 1))
    assert len(a) > 0 and not (len(a) == len(b) and np.array_equal(a, b))


def test_speaker_names_and_ids_out_of_range(served):
    voice, port = served
    q = f"text={urllib.parse.quote(TEXTS[1])}&seed=3"
    by_id = _get(port, q + "&speaker_id=1")
    by_name = _get(port, q + "&speaker=bob")
    assert by_id[0] == 200 and by_name == by_id
    for bad in ("&speaker_id=2", "&speaker_id=-1", "&speaker_id=x"):
        status, body = _get(port, q + bad)
        assert status == 400, bad
    assert _get(port, q + "&speaker_id=7", path="/stream")[0] == 400
    with pytest.raises(ValueError, match="out of range"):
        voice.speaker_id(SynthesisConfig(speaker_id=2))
    batcher, voice.batcher = voice.batcher, None
    try:
        with pytest.raises(ValueError, match="out of range"):
            voice.synthesize_ids_batch([[1, 0, 40, 0, 2]], syn=SynthesisConfig(speaker_id=2))
    finally:
        voice.batcher = batcher
    # the server still answers after the refusals
    assert _get(port, q + "&speaker_id=0")[0] == 200


def test_cli_speaker_out_of_range(voice_path, tmp_path, monkeypatch):
    from piper_tpu_torch.__main__ import main

    monkeypatch.setattr(sys, "stdin", io.StringIO("Hi.\n"))
    with pytest.raises(ValueError, match="out of range"):
        main(["-m", str(voice_path), "-f", str(tmp_path / "x.wav"), "-s", "2", "--device", "cpu"])
