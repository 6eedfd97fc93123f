"""The port's chunked streaming (piper_tpu_torch/runtime/streaming.py) on
the CPU: chunk by chunk against the JAX package's StreamingDecoder on
the same latents and weights, streamed against the port's own batch
path (on the trained x-low voice, whose flows give the seams real
error), short utterances, a final chunk of one frame, and a
multi-speaker voice.

Bounds: 1e-4 against JAX, the vocode tolerance of test_torch_e2e.py
(float32 through the flows and the generator, summed in another order);
p99 < 5e-3 and mean < 1e-3 at the seams, the JAX package's own bounds
(tests/test_streaming.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.config import InferenceDefaults, VoiceConfig
from piper_tpu.runtime.streaming import StreamingDecoder as JaxStreamingDecoder
from piper_tpu.runtime.voice import TpuVoice
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.models.vits import model as M
from piper_tpu_torch.runtime import streaming as S
from piper_tpu_torch.runtime import voice as RV
from torch_parity import TINY, TINY_MS, jax_params, normal, tcfg

DATA = Path(__file__).parent / "data"


def _port_voice(jcfg, tree, precision="parity"):
    cfg = tcfg(jcfg)
    return RV.TorchVoice(tree, cfg, RV.random_voice_config(cfg), precision=precision,
                         device="cpu", seed=0)


def _jax_voice(jcfg, tree):
    id_map = {chr(32 + i): [i] for i in range(jcfg.num_symbols)}
    vconfig = VoiceConfig(
        num_symbols=jcfg.num_symbols, num_speakers=jcfg.num_speakers,
        sample_rate=jcfg.audio.sample_rate, espeak_voice="en-us",
        inference=InferenceDefaults(), phoneme_id_map=id_map,
    )
    return TpuVoice(tree, jcfg, vconfig, precision="parity", phoneme_buckets=[32],
                    frame_buckets=[256], seed=0)


@pytest.fixture(scope="module")
def tiny():
    tree = jax_params(TINY, 3)
    return tree, _port_voice(TINY, tree)


def _ids(rng, n):
    return [1, 0] + [int(x) for s in rng.integers(3, 60, n) for x in (s, 0)] + [2]


def _whole(voice, z_p, n_frames, sid=None):
    """One vocode of the whole utterance: the reference of the seams."""
    with torch.inference_mode():
        mask = torch.ones((1, n_frames, 1))
        return M.synthesizer_vocode(voice.params, z_p[:, :n_frames], mask, cfg=voice.model_cfg,
                                    sid=sid)[0].numpy()


@pytest.mark.parametrize("n_frames", [3 * 45 + 1, 50])
def test_stream_matches_jax_chunk_by_chunk(tiny, n_frames):
    """The same z_p through both packages' decoders (the JAX one pads
    each chunk to its 65-frame window, the port decodes it at its own
    length): the same chunk boundaries and samples within 1e-4. 136
    frames end in a chunk of one frame; 50 is decoded whole."""
    tree, voice = tiny
    z_p = normal(np.random.default_rng(n_frames), (1, n_frames, TINY.inter_channels))
    ref = list(JaxStreamingDecoder(_jax_voice(TINY, tree)).stream(jnp.asarray(z_p), n_frames))
    got = list(S.StreamingDecoder(voice).stream(torch.from_numpy(z_p), n_frames))
    assert [len(c) for c in got] == [len(c) for c in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0, err_msg=f"chunk {i}")


def test_streamed_matches_batched_on_trained_voice():
    """A seeded utterance streamed and batched: the same durations (the
    same encode, bucket and noise), the same length, seams within the
    JAX bounds."""
    voice = RV.TorchVoice.load(DATA / "voice_xlow_trained_fp16.npz", DATA / "voice_xlow_trained.json",
                               precision="parity", device="cpu")
    ids = _ids(np.random.default_rng(1), 40)
    syn = SynthesisConfig(seed=5)
    durations = []
    encode = voice._encode

    def recording_encode(*a, **k):
        enc, frames = encode(*a, **k)
        durations.append(enc.durations.clone())
        return enc, frames

    voice._encode = recording_encode
    chunks = list(S.synthesize_stream_chunks(voice, ids, syn=syn))
    batched = voice.synthesize_ids_batch([ids], syn=syn)[0]
    assert len(chunks) >= 3
    assert len(durations) == 2 and torch.equal(durations[0], durations[1])
    streamed = np.concatenate(chunks)
    assert len(streamed) == len(batched) == int(durations[0].sum()) * voice.model_cfg.upsample_factor
    err = np.abs(streamed - batched)
    assert np.percentile(err, 99) < 5e-3 and err.mean() < 1e-3, (np.percentile(err, 99), err.mean())


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_short_utterance_equals_batch_path(tiny, precision):
    """At most one window: decoded whole, the batch path's samples (fast:
    within the batch path's int16 step)."""
    tree, parity_voice = tiny
    voice = parity_voice if precision == "parity" else _port_voice(TINY, tree, "fast")
    ids = _ids(np.random.default_rng(2), 6)
    syn = SynthesisConfig(seed=9)
    chunks = list(S.synthesize_stream_chunks(voice, ids, syn=syn))
    batched = voice.synthesize_ids_batch([ids], syn=syn)[0]
    assert len(chunks) == 1 and len(chunks[0]) == len(batched) > 0
    assert len(batched) // voice.model_cfg.upsample_factor <= 65
    atol = 1e-6 if precision == "parity" else 0.5 / 32767 + 1e-7
    np.testing.assert_allclose(chunks[0], batched, atol=atol, rtol=0)


def test_final_chunk_of_one_frame(tiny):
    """136 frames: chunks of 45, 45, 45 and 1 (decoded with 10 frames of
    left context), concatenating to the whole decode's samples."""
    _, voice = tiny
    u = TINY.upsample_factor
    z_p = torch.from_numpy(normal(np.random.default_rng(4), (1, 136, TINY.inter_channels)))
    chunks = list(S.StreamingDecoder(voice).stream(z_p, 136))
    assert [len(c) // u for c in chunks] == [45, 45, 45, 1]
    err = np.abs(np.concatenate(chunks) - _whole(voice, z_p, 136))
    assert np.percentile(err, 99) < 5e-3 and err.mean() < 1e-3


def test_multispeaker_stream():
    """TINY_MS with sid 2: the speaker reaches every chunk (the seams
    match the whole decode with the same sid, not with another)."""
    tree = jax_params(TINY_MS, 5)
    voice = _port_voice(TINY_MS, tree)
    z_p = torch.from_numpy(normal(np.random.default_rng(6), (1, 100, TINY_MS.inter_channels)))
    sid = torch.tensor([2])
    streamed = np.concatenate(list(S.StreamingDecoder(voice).stream(z_p, 100, sid)))
    err = np.abs(streamed - _whole(voice, z_p, 100, sid))
    assert np.percentile(err, 99) < 5e-3 and err.mean() < 1e-3
    other = _whole(voice, z_p, 100, torch.tensor([0]))
    assert np.abs(streamed - other).mean() > 10 * err.mean() + 1e-6
    # through synthesize_stream_chunks with syn.speaker_id
    ids = _ids(np.random.default_rng(7), 12)
    syn = SynthesisConfig(seed=3, speaker_id=2)
    chunks = list(S.synthesize_stream_chunks(voice, ids, syn=syn))
    np.testing.assert_allclose(np.concatenate(chunks), voice.synthesize_ids_batch([ids], syn=syn)[0],
                               atol=1e-6, rtol=0)

