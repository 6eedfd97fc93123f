"""The port's threefry streams (piper_tpu_torch/ops/prng.py) against
jax.random on the CPU, and the seeded serving noise built on them
(fault 16): a seeded port voice, with no noise passed in, gives the JAX
package's seeded audio and durations.

Bounds: the keys, the bits and the uniforms bit for bit; the normals
within 1e-6 (the port's log1p is torch's, XLA's erf_inv polynomial
otherwise step by step: about one float32 ulp at |x| ~ 4); the audio of
the batch path within the e2e bound of tests/test_torch_e2e.py (1e-4,
float32 through the encoder, the SDP, the flows and the generator in
another order), with equal lengths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piper_tpu.config import InferenceDefaults, VoiceConfig
from piper_tpu.config import SynthesisConfig as JSynthesisConfig
from piper_tpu.runtime import streaming as JS
from piper_tpu.runtime.voice import TpuVoice
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.ops import prng as P
from piper_tpu_torch.runtime import streaming as S
from piper_tpu_torch.runtime import voice as RV
from torch_parity import TINY, TINY_MS, jax_params, tcfg

SEEDS = [0, 1, 2, 2**32 - 1, 123456789]
SHAPES = [(1,), (7,), (4, 5), (2, 3, 7)]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), P.prng_key(seed)
    np.testing.assert_array_equal(kt.numpy(), _words(kj))
    for data in (0, 1, 7, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(P.fold_in(kt, data).numpy(), _words(jax.random.fold_in(kj, data)))
    for n in (2, 4, 5):
        np.testing.assert_array_equal(P.split(kt, n).numpy(), _words(jax.random.split(kj, n)))
    # a batch of keys and of data: each pair as alone
    data = torch.tensor([3, 99, 2**32 - 2])
    keys = torch.stack([kt, P.fold_in(kt, 5), P.fold_in(kt, 6)])
    np.testing.assert_array_equal(
        P.fold_in(keys, data).numpy(),
        np.stack([_words(jax.random.fold_in(jnp.asarray(k, jnp.uint32), int(d)))
                  for k, d in zip(keys.numpy(), data.numpy())]),
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_normal_equal_jax(seed, shape):
    kj, kt = jax.random.fold_in(jax.random.PRNGKey(seed), 11), P.fold_in(P.prng_key(seed), 11)
    np.testing.assert_array_equal(P.random_bits(kt, shape).numpy(), _words(jax.random.bits(kj, shape)))
    np.testing.assert_array_equal(P.uniform(kt, shape).numpy(), np.asarray(jax.random.uniform(kj, shape)))
    got = P.normal(kt, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.random.normal(kj, shape)), atol=1e-6, rtol=0)


def test_normal_tails_within_an_ulp():
    """200,000 normals (tails out to |x| ~ 4.5): every one within 1e-6."""
    kj, kt = jax.random.PRNGKey(3), P.prng_key(3)
    ref = np.asarray(jax.random.normal(kj, (200_000,)))
    got = P.normal(kt, (200_000,)).numpy()
    assert np.abs(ref).max() > 4.0
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_batched_keys_draw_their_own_streams():
    """normal over a (rows, 2) key table: row r equals its key alone."""
    keys = torch.stack([P.fold_in(P.prng_key(s), 4) for s in (0, 1, 2)])
    together = P.normal(keys, (5, 3))
    assert together.shape == (3, 5, 3)
    for r in range(3):
        assert torch.equal(together[r], P.normal(keys[r], (5, 3)))


def test_utterance_key_and_noise_are_jax_rows():
    """utterance_seed is TpuVoice._utt_keys' key; duration_noise and
    frame_noise are its encode's and row_noise's draws
    (piper_tpu/runtime/voice.py:274-277, :314-324)."""
    ids = [1, 0, 17, 0, 33, 0, 2]
    for seed in (0, 7, 2**32 - 1):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), TpuVoice._content_hashes([ids])[0])
        key = RV.utterance_seed(seed, ids)
        assert (key >> 32, key & P.MASK) == tuple(_words(jkey))
        np.testing.assert_allclose(
            RV.duration_noise(key, 9).numpy(),
            np.asarray(jax.random.normal(jax.random.fold_in(jkey, 0), (9, 2))), atol=1e-6, rtol=0,
        )
        kf = jax.random.fold_in(jkey, 1)
        ref = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(kf, i), (6,))) for i in range(20)])
        np.testing.assert_allclose(RV.frame_noise(key, 20, 6).numpy(), ref, atol=1e-6, rtol=0)


def test_frame_noise_ignores_the_frame_count():
    """Frame f's noise depends only on (key, f): the first 37 frames of
    a 150-frame draw are a 37-frame draw, bit for bit, and the duration
    noise of id i does not depend on the bucket width."""
    key = RV.utterance_seed(5, [1, 0, 9, 0, 2])
    assert torch.equal(RV.frame_noise(key, 150, 8)[:37], RV.frame_noise(key, 37, 8))
    assert torch.equal(RV.duration_noise(key, 64)[:5], RV.duration_noise(key, 5))
    rows = RV.frame_noise_rows(RV.key_table([key, RV.utterance_seed(6, [1, 2])]), 40, 8)
    assert torch.equal(rows[0], RV.frame_noise(key, 40, 8))


# ---------------------------------------------------------------------------
# Fault 16: the seeded audio of both packages
# ---------------------------------------------------------------------------


def _jax_voice(jcfg, tree):
    id_map = {chr(32 + i): [i] for i in range(jcfg.num_symbols)}
    vconfig = VoiceConfig(
        num_symbols=jcfg.num_symbols, num_speakers=jcfg.num_speakers,
        sample_rate=jcfg.audio.sample_rate, espeak_voice="en-us",
        inference=InferenceDefaults(), phoneme_id_map=id_map,
    )
    return TpuVoice(tree, jcfg, vconfig, precision="parity", phoneme_buckets=[64],
                    frame_buckets=[256], seed=0)


def _port_voice(jcfg, tree):
    cfg = tcfg(jcfg)
    return RV.TorchVoice(tree, cfg, RV.random_voice_config(cfg), precision="parity",
                         device="cpu", seed=0)


def _rows(rng, lengths, num_symbols):
    return [[1, 0] + [int(x) for s in rng.integers(3, num_symbols, n) for x in (s, 0)] + [2]
            for n in lengths]


@pytest.mark.parametrize("which", ["single", "multi"])
def test_seeded_batch_equals_jax_seeded_audio(which):
    """Fault 16: synthesize_ids_batch of several rows with one seed, no
    noise passed in, on both packages' voices over the same weights: the
    same lengths and the same samples within 1e-4."""
    jcfg = TINY if which == "single" else TINY_MS
    tree = jax_params(jcfg, 21)
    rows = _rows(np.random.default_rng(22), (4, 11, 19), jcfg.num_symbols)
    kw = dict(seed=1234) if which == "single" else dict(seed=1234, speaker_id=2)
    ref = _jax_voice(jcfg, tree).synthesize_ids_batch(rows, syn=JSynthesisConfig(**kw))
    got = _port_voice(jcfg, tree).synthesize_ids_batch(rows, syn=SynthesisConfig(**kw))
    assert [len(g) for g in got] == [len(r) for r in ref]
    assert min(len(r) for r in ref) > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0, err_msg=f"row {i}")


def test_seeded_stream_has_jax_stream_durations():
    """Fault 16 on the streaming path: a seeded stream's durations equal
    the JAX package's streamed durations (JAX promises streamed and
    batched durations equal, its streaming.py:122-125), and the port's
    stream still has the port's batch path's length."""
    tree = jax_params(TINY, 23)
    ids = _rows(np.random.default_rng(24), (17,), TINY.num_symbols)[0]
    jvoice, tvoice = _jax_voice(TINY, tree), _port_voice(TINY, tree)
    durations = {}

    def recording(voice, name):
        encode = voice._encode

        def spy(*a, **k):
            out = encode(*a, **k)
            durations[name] = np.asarray(out[0].durations)[0]
            return out

        voice._encode = spy

    recording(jvoice, "jax")
    recording(tvoice, "port")
    ref = list(JS.synthesize_stream_chunks(jvoice, ids, syn=JSynthesisConfig(seed=77)))
    got = list(S.synthesize_stream_chunks(tvoice, ids, syn=SynthesisConfig(seed=77)))
    n = len(ids)
    np.testing.assert_array_equal(durations["port"][:n], durations["jax"][:n])
    assert durations["port"][:n].sum() > 0
    assert sum(len(c) for c in got) == sum(len(c) for c in ref)
    batched = tvoice.synthesize_ids_batch([ids], syn=SynthesisConfig(seed=77))[0]
    assert sum(len(c) for c in got) == len(batched)
