"""VITS2 voices in the port against the JAX package, on the CPU: the
windowed attention of the flow (local_attention_apply), a coupling
layer with it, the speaker-conditioned text encoder, encode -> latents
-> vocode end to end, a JAX-written .npz through TorchVoice.load, the
CLI, the server and /stream, streamed chunks against JAX's decoder, and
the weight bridge's refusal of trees that lack what the config runs.

Every test that runs the flow perturbs `flow.layers[*].post` first
(torch_parity.perturb_flow_post, as tests/test_vits2.py does): `post`
is zero-initialised, so with random weights the attention would change
nothing. Tolerances: atol 2e-5 / rtol 1e-4 at module level (the JAX
package's own), 1e-4 end to end and on streamed chunks (test_torch_e2e
and test_torch_streaming's: float32 through the encoder, the SDP, four
flows with attention and the generator, summed in another order).
"""

import dataclasses
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

from piper_tpu.models.vits import encoder as JE
from piper_tpu.models.vits import flow as JF
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.models.vits import encoder as TE
from piper_tpu_torch.models.vits import flow as TF
from piper_tpu_torch.runtime import streaming as S
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.weights.bridge import params_from_jax
from test_torch_e2e import _e2e, _ids
from torch_parity import (
    TINY_VITS2, close, mask_np, normal, np_tree, perturb_flow_post, port_params, t, tcfg,
)

# one speaker: the flow's attention without the encoder's speaker input
TINY_VITS2_1 = dataclasses.replace(
    TINY_VITS2, num_speakers=1, gin_channels=0, speaker_cond_encoder=False,
)


def _port_tree(cfg, seed):
    """A random tree of `cfg` from the port's own initialiser (numpy, in
    the JAX layouts; test_port_init_matches_jax_tree holds its structure
    to the JAX package's), `post` perturbed."""
    from piper_tpu_torch.models.vits.model import init_synthesizer_params

    return perturb_flow_post(init_synthesizer_params(seed, tcfg(cfg)), seed=seed)


@pytest.fixture(scope="module")
def tree():
    return _port_tree(TINY_VITS2, 3)


@pytest.mark.parametrize("cfg", [TINY_VITS2, TINY_VITS2_1], ids=["two_speakers", "one_speaker"])
def test_port_init_matches_jax_tree(cfg):
    """The port's init_synthesizer_params gives the JAX package's tree
    for a VITS2 config: the same leaves (attn and attn_norm in every
    coupling layer, enc_p.cond with speakers), shapes and dtypes."""
    from piper_tpu.models.vits.model import init_synthesizer_params as jax_init
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.weights.bridge import iter_leaves

    ref = jax.eval_shape(lambda k: jax_init(k, cfg), jax.random.PRNGKey(0))
    got = init_synthesizer_params(0, tcfg(cfg))
    assert sorted((k, tuple(v.shape)) for k, v in iter_leaves(got)) == \
        sorted((k, tuple(v.shape)) for k, v in iter_leaves(ref))
    assert all(v.dtype == np.float32 for _, v in iter_leaves(got))
    assert ("enc_p.cond.w" in dict(iter_leaves(got))) == (cfg.num_speakers > 1)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("heads", [1, 2], ids=["shared_tables", "per_head_tables"])
def test_local_attention_matches_jax(heads):
    """Band-form windowed attention on a ragged batch: valid positions
    within atol 2e-5 / rtol 1e-4. The relative tables shared by the
    heads (1, 9, d), as init_attention makes them, or one per head."""
    p = np_tree(JE.init_attention(jax.random.PRNGKey(0), 32, 2))
    rng = np.random.default_rng(heads)
    for name in ("emb_rel_k", "emb_rel_v"):
        p[name] = normal(rng, (heads, 9, 16), 0.25)
    lens = [23, 9, 2]
    m = mask_np(lens, 23)
    x = normal(rng, (3, 23, 32)) * m
    ref = JE.local_attention_apply(_jnp(p), jnp.asarray(x), jnp.asarray(m), n_heads=2)
    got = TE.local_attention_apply(_torch(p), t(x), t(m), n_heads=2)
    for i, n in enumerate(lens):
        close(got[i, :n], np.asarray(ref)[i, :n], what=f"row {i}")


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_coupling_layer_with_attention_matches_jax(tree, reverse):
    """One VITS2 coupling layer (WN, then the attention block and its
    layer norm), `post` perturbed, with a speaker's g, both directions."""
    lp = tree["flow"]["layers"][1]
    assert "attn" in lp and "attn_norm" in lp and np.abs(lp["post"]["w"]).max() > 0
    rng = np.random.default_rng(5)
    lens = [31, 17]
    m = mask_np(lens, 31)
    x = normal(rng, (2, 31, TINY_VITS2.inter_channels)) * m
    g = normal(rng, (2, TINY_VITS2.gin_channels))
    ref = JF.coupling_layer_apply(_jnp(lp), jnp.asarray(x), jnp.asarray(m), cfg=TINY_VITS2,
                                  g=jnp.asarray(g), reverse=reverse)
    got = TF.coupling_layer_apply(_torch(lp), t(x), t(m), cfg=tcfg(TINY_VITS2), g=t(g),
                                  reverse=reverse)
    if not reverse:
        ref, got = ref[0], got[0]
    close(got, ref)
    # the attention moved the output: the layer without it differs
    plain = {k: v for k, v in lp.items() if k not in ("attn", "attn_norm")}
    bare = JF.coupling_layer_apply(_jnp(plain), jnp.asarray(x), jnp.asarray(m), cfg=TINY_VITS2,
                                   g=jnp.asarray(g), reverse=reverse)
    bare = bare[0] if not reverse else bare
    assert np.abs(np.asarray(bare) - np.asarray(ref)).max() > 1e-3


def test_flow_reverse_matches_jax(tree):
    """The whole VITS2 flow, reverse, as the decode runs it."""
    rng = np.random.default_rng(6)
    m = mask_np([40, 26, 7], 40)
    x = normal(rng, (3, 40, TINY_VITS2.inter_channels)) * m
    g = normal(rng, (3, TINY_VITS2.gin_channels))
    ref = JF.flow_apply(_jnp(tree["flow"]), jnp.asarray(x), jnp.asarray(m), cfg=TINY_VITS2,
                        g=jnp.asarray(g), reverse=True)
    got = TF.flow_apply(port_params(tree, TINY_VITS2)["flow"], t(x), t(m), cfg=tcfg(TINY_VITS2),
                        g=t(g), reverse=True)
    close(got, ref, atol=1e-4)


def test_text_encoder_with_speaker_cond_matches_jax(tree):
    """text_encoder_apply with enc_p.cond and a speaker's g: hidden, m_p
    and logs_p; the speaker moves them."""
    enc = tree["enc_p"]
    assert "cond" in enc
    rng = np.random.default_rng(7)
    lens = [19, 11]
    ids = rng.integers(0, TINY_VITS2.num_symbols, (2, 19)).astype(np.int32)
    m = mask_np(lens, 19)
    g = normal(rng, (2, TINY_VITS2.gin_channels))
    ref = JE.text_encoder_apply(_jnp(enc), jnp.asarray(ids), jnp.asarray(m), cfg=TINY_VITS2,
                                g=jnp.asarray(g))
    p = port_params(tree, TINY_VITS2)["enc_p"]
    got = TE.text_encoder_apply(p, t(ids).long(), t(m), cfg=tcfg(TINY_VITS2), g=t(g))
    for name, a, b in zip(("x", "m_p", "logs_p"), got, ref):
        close(a, b, what=name)
    other = TE.text_encoder_apply(p, t(ids).long(), t(m), cfg=tcfg(TINY_VITS2), g=t(g[::-1].copy()))
    assert (other[1] - got[1]).abs().max() > 1e-3


@pytest.mark.parametrize("which", ["two_speakers", "one_speaker"])
def test_encode_latents_vocode_vits2(which, request):
    """encode -> latents -> vocode in both packages, noise passed in:
    equal durations, audio within 1e-4 (the HiFiGAN generator on the
    JAX side, the port's time-major generator on its side)."""
    cfg = TINY_VITS2 if which == "two_speakers" else TINY_VITS2_1
    tree = request.getfixturevalue("tree") if which == "two_speakers" else _port_tree(cfg, 4)
    rng = np.random.default_rng(8)
    lens = np.array([25, 13, 6], np.int32)
    ids = _ids(rng, 3, lens, cfg.num_symbols)
    sid = np.array([2, 0, 1], np.int32) if cfg.num_speakers > 1 else None
    _e2e(tree, cfg, ids, lens, sid, seed=9, atol=1e-4)


# ---------------------------------------------------------------------------
# A JAX-written .npz through the port's entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def npz(tree, tmp_path_factory):
    """TINY_VITS2's tree (post perturbed) written by the JAX package's
    save_native, with a text-phoneme sidecar."""
    from piper_tpu.weights.native import save_native

    d = tmp_path_factory.mktemp("vits2")
    save_native(str(d / "voice.npz"), tree, TINY_VITS2)
    (d / "voice.npz.json").write_text(json.dumps(RV.random_voice_config(tcfg(TINY_VITS2)).to_dict()))
    return d / "voice.npz"


def _rows(n_rows=4):
    rng = np.random.default_rng(10)
    return [[1, 0] + [int(x) for s in rng.integers(3, 60, n) for x in (s, 0)] + [2]
            for n in (3, 14, 27, 9)[:n_rows]]


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_npz_loads_and_synthesizes(npz, precision):
    """TorchVoice.load of the JAX-written .npz: the VITS2 config read
    back, rows in one batch each equal to the row alone, speakers that
    differ, and a streamed request of the batch path's length, whose
    one-window chunk equals the batch path's samples."""
    voice = RV.TorchVoice.load(npz, device="cpu", precision=precision, seed=0)
    cfg = voice.model_cfg
    assert cfg.flow_transformer and cfg.speaker_cond_encoder and cfg.num_speakers == 3
    assert "dec_tm" in voice.params and "dec_mb" not in voice.params
    rows = _rows()
    syn = SynthesisConfig(speaker_id=2)
    together = voice.collect(voice.submit(rows, syn=syn, row_seeds=list(range(4))))
    for i, row in enumerate(rows):
        alone = voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=i, speaker_id=2))[0]
        assert len(alone) > 0 and np.isfinite(alone).all()
        np.testing.assert_array_equal(together[i], alone, err_msg=f"row {i}")
    other = voice.synthesize_ids_batch([rows[2]], syn=SynthesisConfig(seed=2, speaker_id=0))[0]
    assert len(other) != len(together[2]) or np.abs(other - together[2]).mean() > 1e-5
    syn = SynthesisConfig(seed=3, speaker_id=1)
    streamed = np.concatenate(list(S.synthesize_stream_chunks(voice, rows[1], syn=syn)))
    batched = voice.synthesize_ids_batch([rows[1]], syn=syn)[0]
    assert len(streamed) == len(batched)
    atol = 1e-6 if precision == "parity" else 0.5 / 32767 + 1e-7
    np.testing.assert_allclose(streamed, batched, atol=atol, rtol=0)


def test_streamed_chunks_match_jax(tree):
    """The same z_p through JAX's StreamingDecoder and the port's (its
    chunk graph's fixed-window function, the attention under the window's
    mask), speaker 1: the same chunks within 1e-4."""
    from piper_tpu.config import InferenceDefaults, VoiceConfig
    from piper_tpu.runtime.streaming import StreamingDecoder as JaxStreamingDecoder
    from piper_tpu.runtime.voice import TpuVoice

    cfg = tcfg(TINY_VITS2)
    voice = RV.TorchVoice(tree, cfg, RV.random_voice_config(cfg), precision="parity",
                          device="cpu", seed=0)
    jvoice = TpuVoice(
        tree, TINY_VITS2,
        VoiceConfig(num_symbols=64, num_speakers=3, sample_rate=16000, espeak_voice="en-us",
                    inference=InferenceDefaults(), phoneme_id_map={"_": [0]}),
        precision="parity", phoneme_buckets=[32], frame_buckets=[256], seed=0,
    )
    n = 2 * 45 + 7
    z_p = normal(np.random.default_rng(11), (1, n, TINY_VITS2.inter_channels))
    ref = list(JaxStreamingDecoder(jvoice).stream(jnp.asarray(z_p), n, jnp.asarray([1])))
    got = list(S.StreamingDecoder(voice).stream(torch.from_numpy(z_p), n, torch.tensor([1])))
    assert [len(c) for c in got] == [len(c) for c in ref] and len(got) == 3
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"chunk {i}")


def _pcm(wav):
    with wave.open(io.BytesIO(wav), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_cli_server_and_stream(npz, monkeypatch, tmp_path):
    """python -m piper_tpu_torch -m voice.npz --batch on the CPU writes
    a WAV per line; the server with the batcher answers / with the same
    bytes twice for speaker 2 and /stream with the batch path's sample
    count."""
    from piper_tpu_torch.__main__ import main
    from piper_tpu_torch.server.batcher import CoalescingBatcher
    from piper_tpu_torch.server.http_server import serve

    monkeypatch.setattr(sys, "stdin", io.StringIO("Hello there.\nA second line.\n"))
    main(["-m", str(npz), "-d", str(tmp_path), "--batch", "--seed", "1", "--device", "cpu",
          "--speaker", "2", "-q"])
    wavs = sorted(tmp_path.glob("*.wav"))
    assert len(wavs) == 2 and all(len(_pcm(p.read_bytes())) > 0 for p in wavs)

    voice = RV.TorchVoice.load(npz, device="cpu", precision="fast", seed=0)
    voice.batcher = CoalescingBatcher(voice, window_ms=20.0, max_batch=16)
    server = serve(voice, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        q = f"text={urllib.parse.quote('Hello there.')}&seed=1&speaker_id=2"
        got = []
        for _ in range(2):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/?{q}", timeout=120) as r:
                got.append(r.read())
        assert got[0] == got[1] and len(_pcm(got[0])) > 0
        text = "A sentence long enough to be streamed in chunks, " * 2
        q = f"text={urllib.parse.quote(text)}&seed=4&speaker_id=1"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream?{q}", timeout=120) as r:
            pcm = np.frombuffer(r.read(), "<i2")
        ids = voice.phonemes_to_ids(voice.phonemize(text.strip())[0])
        batched = voice.synthesize_ids_batch([ids], syn=SynthesisConfig(seed=4, speaker_id=1))[0]
        assert len(pcm) == len(batched) > 65 * voice.model_cfg.upsample_factor
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        voice.batcher.close()


@pytest.mark.parametrize("missing", ["attn", "attn_norm", "enc_p.cond"])
def test_bridge_refuses_a_tree_without_what_the_config_runs(tree, missing):
    """flow_transformer needs attn and attn_norm in every coupling layer,
    speaker_cond_encoder enc_p.cond: a tree without them is refused when
    it is loaded, not run without them."""
    bad = dict(tree)
    if missing == "enc_p.cond":
        bad["enc_p"] = {k: v for k, v in tree["enc_p"].items() if k != "cond"}
    else:
        layers = [dict(lp) for lp in tree["flow"]["layers"]]
        del layers[2][missing]
        bad["flow"] = {"layers": layers}
    with pytest.raises(ValueError, match="attn" if missing != "enc_p.cond" else "cond"):
        params_from_jax(bad, tcfg(TINY_VITS2))
    params_from_jax(tree, tcfg(TINY_VITS2))  # the whole tree loads


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_vits2_flow_runs_at_own_bucket_in_fixed_row_graphs(npz, precision, monkeypatch):
    """A VITS2 voice's reverse flow (both precisions) runs each row at the
    frame bucket it decodes at alone, in graphs of flow_graph_rows(bucket)
    rows padded with copies, so a row's flow has one shape alone and in
    any batch, whatever the decode grouping: here rows of two frame
    buckets decoded as one uniform group."""
    voice = RV.TorchVoice.load(npz, device="cpu", precision=precision, seed=0,
                               decode_grouping="uniform")
    voice.frame_buckets = [16, 32, 64, 128, 256, 512]
    monkeypatch.setattr(RV, "FLOW_FRAMES", 128)  # bf16: 8 rows at bucket 16 down to 1 at 128
    shapes = []
    flow = voice._flow

    def spy(m_p, *inputs):  # the flow graph's inputs: the latents' and sid
        shapes.append(tuple(m_p.shape[:2]))
        return flow(m_p, *inputs)

    voice._flow = spy
    rows = _rows()
    together = voice.collect(voice.submit(rows, row_seeds=list(range(4))))
    frames = [len(a) // voice.model_cfg.upsample_factor for a in together]
    own = sorted({min(b for b in voice.frame_buckets if b >= f) for f in frames})
    assert len(own) >= 2, frames  # the rows span buckets
    assert sorted(set(shapes)) == sorted((RV.flow_graph_rows(b, voice.dtype), b) for b in own)
    shapes.clear()
    alone = voice.synthesize_ids_batch([rows[0]], syn=SynthesisConfig(seed=0))[0]
    first = min(b for b in voice.frame_buckets if b >= frames[0])
    assert shapes == [(RV.flow_graph_rows(first, voice.dtype), first)]
    np.testing.assert_array_equal(together[0], alone)
