"""MB-iSTFT voices in the port against the JAX package, on the CPU:
istft and the PQMF bank (piper_tpu/ops/istft.py), the
generator on a ragged masked batch and row by row, encode -> latents ->
vocode end to end, a JAX-written .npz through TorchVoice.load, the CLI,
the server and /stream, streamed chunks against JAX's decoder, and the
weight bridge's refusal of trees that do not match an MB-iSTFT config.

Tolerances: atol 2e-5 / rtol 1e-4 for the signal ops (the JAX
package's module tolerance); 1e-4 for the generator, end to end and on
streamed chunks (test_torch_e2e's: float32 through the conv stack, the
exp of the log magnitudes and the overlap-add, summed in another
order); the JAX package's own 1e-4 for a masked batch row against the
row alone (tests/test_mb_istft.py:121); the row-by-row mode holds a row
to the row alone bit for bit.
"""

import io
import json
import sys
import threading
import urllib.parse
import urllib.request
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piper_tpu.models.vits import istft_generator as JG
from piper_tpu.ops import istft as JI
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.models.vits import istft_generator as TG
from piper_tpu_torch.models.vits.model import init_synthesizer_params
from piper_tpu_torch.ops import istft as TI
from piper_tpu_torch.runtime import streaming as S
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.weights.bridge import params_from_jax
from test_torch_e2e import _e2e, _ids
from torch_parity import TINY_MB, close, mask_np, normal, port_params, t, tcfg

U = TINY_MB.upsample_factor
MB_ATOL = 1e-4


@pytest.fixture(scope="module")
def tree():
    return init_synthesizer_params(3, tcfg(TINY_MB))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_port_init_matches_jax_tree():
    """The port's init_synthesizer_params gives the JAX package's MB-iSTFT
    tree: HiFiGAN's stages at 4-4 and a conv_post of subbands * (n_fft +
    2) outputs with a bias; the same leaves and shapes."""
    from piper_tpu.models.vits.model import init_synthesizer_params as jax_init
    from piper_tpu_torch.weights.bridge import iter_leaves

    ref = jax.eval_shape(lambda k: jax_init(k, TINY_MB), jax.random.PRNGKey(0))
    got = init_synthesizer_params(0, tcfg(TINY_MB))
    assert sorted((k, tuple(v.shape)) for k, v in iter_leaves(got)) == \
        sorted((k, tuple(v.shape)) for k, v in iter_leaves(ref))
    assert got["dec"]["conv_post"]["w"].shape == (7, 16, 4 * 18)


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "frame_mask"])
def test_istft_matches_jax(masked):
    rng = np.random.default_rng(1)
    re, im = normal(rng, (3, 21, 9)), normal(rng, (3, 21, 9))
    fm = mask_np([21, 12, 1], 21)[..., 0] if masked else None
    ref = JI.istft(jnp.asarray(re), jnp.asarray(im), n_fft=16, hop_length=4,
                   frame_mask=None if fm is None else jnp.asarray(fm))
    got = TI.istft(t(re), t(im), n_fft=16, hop_length=4, frame_mask=None if fm is None else t(fm))
    assert got.shape == (3, 21 * 4) and got.dtype == torch.float32
    close(got, ref)


def test_pqmf_filters_and_synthesis_match_jax():
    """The same firwin prototype and cosine modulation (equal arrays), and
    the synthesis bank's conv (not flipped: both are cross-correlations)."""
    for a, b in zip(TI.pqmf_filters(4), JI.pqmf_filters(4)):
        np.testing.assert_array_equal(a, b)
    bands = normal(np.random.default_rng(2), (2, 40, 4))
    close(TI.pqmf_synthesis(t(bands), 4), JI.pqmf_synthesis(jnp.asarray(bands), 4))


def test_generator_matches_jax_on_a_ragged_masked_batch(tree):
    """mb_istft_generator_apply under a length mask, and the row-by-row
    mode at the host lengths, against JAX's masked batch: valid samples
    within 1e-4, zeros past each row."""
    lens = [24, 15, 3]
    m = mask_np(lens, 24)
    z = normal(np.random.default_rng(3), (3, 24, TINY_MB.inter_channels)) * m
    ref = np.asarray(JG.mb_istft_generator_apply(_jnp(tree["dec"]), jnp.asarray(z), jnp.asarray(m),
                                                 cfg=TINY_MB))
    dec = port_params(tree, TINY_MB)["dec"]
    masked = TG.mb_istft_generator_apply(dec, t(z), t(m), cfg=tcfg(TINY_MB))
    rows = TG.mb_istft_generator_rows(dec, t(z), lens, cfg=tcfg(TINY_MB))
    assert masked.shape == rows.shape == (3, 24 * U)
    for i, n in enumerate(lens):
        close(masked[i, : n * U], ref[i, : n * U], atol=MB_ATOL, rtol=0, what=f"masked row {i}")
        close(rows[i, : n * U], ref[i, : n * U], atol=MB_ATOL, rtol=0, what=f"row-by-row row {i}")
        assert not masked[i, n * U :].any() and not rows[i, n * U :].any()
    assert float(np.abs(ref).max()) > 1e-3


def test_batch_row_equals_the_row_alone(tree):
    """As tests/test_mb_istft.py:121: a padded batch row against the row
    synthesized alone. Row by row the bits are the row alone's; under the
    mask within the JAX package's 1e-4."""
    dec = port_params(tree, TINY_MB)["dec"]
    cfg = tcfg(TINY_MB)
    lens = [24, 15]
    m = mask_np(lens, 24)
    z = t(normal(np.random.default_rng(4), (2, 24, TINY_MB.inter_channels)) * m)
    solo = TG.mb_istft_generator_apply(dec, z[1:2, :15], None, cfg=cfg)[0]
    rows = TG.mb_istft_generator_rows(dec, z, lens, cfg=cfg)
    assert torch.equal(rows[1, : 15 * U], solo)
    masked = TG.mb_istft_generator_apply(dec, z, t(m), cfg=cfg)
    close(masked[1, : 15 * U], solo.numpy(), atol=MB_ATOL, rtol=0)


def test_encode_latents_vocode_mb_istft(tree):
    """encode -> latents -> vocode in both packages, noise passed in:
    equal durations, audio within 1e-4."""
    rng = np.random.default_rng(5)
    lens = np.array([27, 14, 6], np.int32)
    ids = _ids(rng, 3, lens, TINY_MB.num_symbols)
    _e2e(tree, TINY_MB, ids, lens, None, seed=6, atol=1e-4)


# ---------------------------------------------------------------------------
# A JAX-written .npz through the port's entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def npz(tree, tmp_path_factory):
    """TINY_MB's tree written by the JAX package's save_native, with a
    text-phoneme sidecar."""
    from piper_tpu.weights.native import save_native

    d = tmp_path_factory.mktemp("mb_istft")
    save_native(str(d / "voice.npz"), tree, TINY_MB)
    (d / "voice.npz.json").write_text(json.dumps(RV.random_voice_config(tcfg(TINY_MB)).to_dict()))
    return d / "voice.npz"


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_npz_loads_and_synthesizes(npz, precision):
    """TorchVoice.load of the JAX-written .npz: the MB-iSTFT config read
    back, the iSTFT tables in place of the time-major weights, rows in
    one batch each equal to the row alone, and a streamed request whose
    one-window chunk equals the batch path's samples."""
    voice = RV.TorchVoice.load(npz, device="cpu", precision=precision, seed=0)
    assert voice.model_cfg.vocoder == "mb_istft" and voice.model_cfg.upsample_factor == 256
    assert "dec_mb" in voice.params and "dec_tm" not in voice.params
    rng = np.random.default_rng(7)
    rows = [[1, 0] + [int(x) for s in rng.integers(3, 60, n) for x in (s, 0)] + [2] for n in (3, 14, 27, 9)]
    together = voice.collect(voice.submit(rows, row_seeds=list(range(4))))
    for i, row in enumerate(rows):
        alone = voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=i))[0]
        assert len(alone) > 0 and np.isfinite(alone).all() and np.abs(alone).max() > 0
        np.testing.assert_array_equal(together[i], alone, err_msg=f"row {i}")
    syn = SynthesisConfig(seed=3)
    streamed = np.concatenate(list(S.synthesize_stream_chunks(voice, rows[1], syn=syn)))
    batched = voice.synthesize_ids_batch([rows[1]], syn=syn)[0]
    atol = 1e-6 if precision == "parity" else 0.5 / 32767 + 1e-7
    np.testing.assert_allclose(streamed, batched, atol=atol, rtol=0)


def test_streamed_chunks_match_jax(tree):
    """The same z_p through JAX's StreamingDecoder and the port's (the
    MB-iSTFT generator at the fixed 65-frame window under the mask, the
    chunk graph's function): the same chunks within 1e-4."""
    from piper_tpu.config import InferenceDefaults, VoiceConfig
    from piper_tpu.runtime.streaming import StreamingDecoder as JaxStreamingDecoder
    from piper_tpu.runtime.voice import TpuVoice

    cfg = tcfg(TINY_MB)
    voice = RV.TorchVoice(tree, cfg, RV.random_voice_config(cfg), precision="parity",
                          device="cpu", seed=0)
    jvoice = TpuVoice(
        tree, TINY_MB,
        VoiceConfig(num_symbols=64, num_speakers=1, sample_rate=16000, espeak_voice="en-us",
                    inference=InferenceDefaults(), phoneme_id_map={"_": [0]}),
        precision="parity", phoneme_buckets=[32], frame_buckets=[256], seed=0,
    )
    n = 2 * 45 + 7
    z_p = normal(np.random.default_rng(8), (1, n, TINY_MB.inter_channels))
    ref = list(JaxStreamingDecoder(jvoice).stream(jnp.asarray(z_p), n))
    got = list(S.StreamingDecoder(voice).stream(torch.from_numpy(z_p), n))
    assert [len(c) for c in got] == [len(c) for c in ref] and len(got) == 3
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"chunk {i}")


def _pcm(wav):
    with wave.open(io.BytesIO(wav), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_cli_server_and_stream(npz, monkeypatch, tmp_path):
    """python -m piper_tpu_torch -m voice.npz --batch on the CPU writes a
    WAV per line; the server with the batcher answers / with the same
    bytes twice and /stream with the batch path's sample count."""
    from piper_tpu_torch.__main__ import main
    from piper_tpu_torch.server.batcher import CoalescingBatcher
    from piper_tpu_torch.server.http_server import serve

    monkeypatch.setattr(sys, "stdin", io.StringIO("Hello there.\nA second line.\n"))
    main(["-m", str(npz), "-d", str(tmp_path), "--batch", "--seed", "1", "--device", "cpu", "-q"])
    wavs = sorted(tmp_path.glob("*.wav"))
    assert len(wavs) == 2 and all(len(_pcm(p.read_bytes())) % U == 0 for p in wavs)

    voice = RV.TorchVoice.load(npz, device="cpu", precision="fast", seed=0)
    voice.batcher = CoalescingBatcher(voice, window_ms=20.0, max_batch=16)
    server = serve(voice, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        q = f"text={urllib.parse.quote('Hello there.')}&seed=1"
        got = []
        for _ in range(2):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/?{q}", timeout=120) as r:
                got.append(r.read())
        assert got[0] == got[1] and len(_pcm(got[0])) > 0
        text = "A sentence long enough to be streamed in chunks, " * 2
        q = f"text={urllib.parse.quote(text)}&seed=4"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream?{q}", timeout=120) as r:
            pcm = np.frombuffer(r.read(), "<i2")
        ids = voice.phonemes_to_ids(voice.phonemize(text.strip())[0])
        batched = voice.synthesize_ids_batch([ids], syn=SynthesisConfig(seed=4))[0]
        assert len(pcm) == len(batched) > 65 * U
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        voice.batcher.close()


@pytest.mark.parametrize("bad", ["conv_post_width", "conv_post_bias", "ups_shape", "hifigan_tree"])
def test_bridge_refuses_a_tree_that_is_not_mb_istft(tree, bad):
    """An MB-iSTFT config with a conv_post of the wrong width or without
    its bias, an upsample stage of the wrong shape, or a HiFiGAN
    generator's tree: refused when it is loaded."""
    dec = dict(tree["dec"])
    if bad == "conv_post_width":
        dec["conv_post"] = {"w": np.zeros((7, 16, 4 * 17), np.float32), "b": np.zeros(68, np.float32)}
    elif bad == "conv_post_bias":
        dec["conv_post"] = {"w": tree["dec"]["conv_post"]["w"]}
    elif bad == "ups_shape":
        dec["ups"] = [dict(tree["dec"]["ups"][0]), {"w": np.zeros((8, 32, 8), np.float32),
                                                  "b": np.zeros(8, np.float32)}]
    else:
        dec["conv_post"] = {"w": np.zeros((7, 16, 1), np.float32)}
    with pytest.raises(ValueError, match="dec.conv_post|dec.ups.1"):
        params_from_jax({**tree, "dec": dec}, tcfg(TINY_MB))
    params_from_jax(tree, tcfg(TINY_MB))  # the whole tree loads


def test_random_refuses_mb_istft_with_vits2_as_jax_does():
    """TorchVoice.random(vocoder="mb_istft", variant="vits2") raises the
    ValueError TpuVoice.random raises, before any weight is made; each
    variant alone builds."""
    from piper_tpu.runtime.voice import TpuVoice

    for cls in (TpuVoice, RV.TorchVoice):
        with pytest.raises(ValueError, match="mb_istft.*vits2"):
            cls.random("x-low", vocoder="mb_istft", variant="vits2", device="cpu") \
                if cls is RV.TorchVoice else cls.random("x-low", vocoder="mb_istft", variant="vits2")
    v = RV.TorchVoice.random("x-low", vocoder="mb_istft", device="cpu")
    assert v.model_cfg.vocoder == "mb_istft" and v.model_cfg.upsample_factor == 256
    v = RV.TorchVoice.random("x-low", variant="vits2", num_speakers=2, device="cpu")
    assert v.model_cfg.flow_transformer and v.model_cfg.speaker_cond_encoder
    assert all("attn" in lp for lp in v.params["flow"]["layers"]) and "cond" in v.params["enc_p"]
