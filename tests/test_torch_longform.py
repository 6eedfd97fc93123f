"""Rows past the frame-bucket ladder, on the CPU: the JAX package
decodes such a row in overlapping windows of its largest frame bucket
(TpuVoice._decode_longform_parts), the port in one call. With the
tiny config and the frame_buckets=[96, 192] of tests/test_longform.py,
a row of a few hundred frames takes JAX's windowed path; the port's
decode of the same row must equal it within JAX's own bound for its
windows against one decode (2e-4 in parity). noise_scale=0 and
noise_w=0, so neither package draws noise.

The port runs the row past its own ladder (the same [96, 192]: it
decodes the row alone at its frame count) and on its default ladder
(the row at a frame bucket, as any other).
"""

import numpy as np
import pytest

from piper_tpu.config import InferenceDefaults, SynthesisConfig, VoiceConfig
from piper_tpu.runtime.voice import TpuVoice
from piper_tpu_torch.config import SynthesisConfig as TSynthesisConfig
from piper_tpu_torch.models.vits.model import init_synthesizer_params
from piper_tpu_torch.runtime import batching
from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config
from test_longform import tiny_cfg
from torch_parity import tcfg

LADDER = [96, 192]


@pytest.fixture(scope="module")
def voices():
    """The JAX voice with the short ladder, and the weights."""
    cfg = tiny_cfg()
    params = init_synthesizer_params(3, tcfg(cfg))
    id_map = {chr(32 + i): [i] for i in range(cfg.num_symbols)}
    id_map.update({"_": [0], "^": [1], "$": [2]})
    vconfig = VoiceConfig(
        num_symbols=cfg.num_symbols, num_speakers=1, sample_rate=cfg.audio.sample_rate,
        espeak_voice="en-us", inference=InferenceDefaults(), phoneme_id_map=id_map,
    )
    jax_voice = TpuVoice(params, cfg, vconfig, precision="parity", phoneme_buckets=[32],
                         frame_buckets=LADDER, seed=0)
    return cfg, params, jax_voice


def _port_voice(cfg, params, ladder):
    voice = TorchVoice(params, tcfg(cfg), random_voice_config(tcfg(cfg)), precision="parity",
                       device="cpu")
    if ladder == "short":
        voice.frame_buckets = list(LADDER)
    return voice


def _long_row(cfg, jax_voice):
    """ids and scales of a row past the ladder (at noise_w=0 these
    weights give each id about one frame per unit of length_scale), and
    JAX's windowed audio."""
    ids = np.random.default_rng(5).integers(3, cfg.num_symbols, 24).tolist()
    syn = dict(seed=11, length_scale=20.0, noise_scale=0.0, noise_w=0.0)
    ref = jax_voice.synthesize_ids_batch([ids], syn=SynthesisConfig(**syn))[0]
    frames = len(ref) // cfg.upsample_factor
    assert frames > LADDER[-1], "the row must overflow the ladder"
    return ids, syn, ref, frames


@pytest.mark.parametrize("ladder", ["short", "default"])
def test_one_call_equals_jax_windows(voices, ladder):
    cfg, params, jax_voice = voices
    ids, syn, ref, frames = _long_row(cfg, jax_voice)
    assert frames > 2 * LADDER[-1] - 2 * jax_voice._longform_halo(LADDER[-1])  # 3+ windows
    voice = _port_voice(cfg, params, ladder)
    handle = voice.submit([ids], syn=TSynthesisConfig(**syn))
    assert handle["decodes"] == 1  # one call
    out = voice.collect(handle)[0]
    assert len(out) == len(ref) == frames * cfg.upsample_factor
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    assert np.abs(ref).max() > 1e-3


@pytest.mark.parametrize("ladder", ["short", "default"])
def test_mixed_batch_long_and_short_rows(voices, ladder):
    """A batch of a long row and two short ones (tests/test_longform.py's
    mixed batch): the long row alone past the port's short ladder, the
    short rows at a frame bucket."""
    cfg, params, jax_voice = voices
    ids, syn, _, frames = _long_row(cfg, jax_voice)
    short_ids = np.random.default_rng(7).integers(3, cfg.num_symbols, 6).tolist()
    rows = [ids, short_ids, short_ids]
    refs = jax_voice.synthesize_ids_batch(rows, syn=SynthesisConfig(**syn))
    voice = _port_voice(cfg, params, ladder)
    handle = voice.submit(rows, syn=TSynthesisConfig(**syn))
    assert handle["decodes"] == 2  # the long row's frame bucket, or itself alone; the short rows
    outs = voice.collect(handle)
    assert [len(o) for o in outs] == [len(r) for r in refs]
    assert len(outs[0]) == frames * cfg.upsample_factor
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o, r, atol=2e-4, rtol=0)


def test_past_the_ladder_rows_decode_alone():
    """The port's plan: rows past the ladder each decode alone at their
    own frame count, after the planned rows (any grouping)."""
    voice = TorchVoice.__new__(TorchVoice)
    voice.frame_buckets = list(LADDER)
    for grouping in batching.DECODE_GROUPINGS:
        voice.decode_grouping = grouping
        plan = voice._plan_decode_groups([50, 400, 150, 193])
        assert plan[-2:] == [(400, [1]), (193, [3])]
        assert sorted(j for _, rows in plan[:-2] for j in rows) == [0, 2]
