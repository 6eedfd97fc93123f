"""The port's weight loaders against the JAX package's, on the CPU.

- ONNX voices written by the JAX package's exporter
  (piper_tpu.onnx_io.export_onnx_voice) in single-speaker, multi-speaker
  and resblock "1" variants, read by both packages' load_onnx_voice, with
  and without a base config: equal trees bit for bit and equal
  ModelConfigs field by field;
- _recover_folded_names and _synthesize_pruned_sdp_flow on synthetic
  initializer and node tables;
- state dicts: the port's state_dict_from_params against the JAX
  package's key for key, and .ckpt files (Lightning layout with
  hyper_parameters, weight-norm pairs and a posterior; a raw state
  dict) read by both load_torch_checkpoint;
- TorchVoice.load of .onnx, .ckpt and .npz files of the same weights:
  the same bytes for the same seed, and the .onnx voice's audio against
  the JAX package's infer on the JAX-loaded weights.

The weights come from the port's numpy initialiser (fast, no JAX
tracing); both packages take the same numpy tree.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.config import AudioConfig, ModelConfig, VoiceConfig
from piper_tpu.models.vits import model as JM
from piper_tpu.onnx_io import export_onnx_voice
from piper_tpu.weights import onnx_loader as j_onnx
from piper_tpu.weights import torch_export as j_export
from piper_tpu.weights import torch_loader as j_torch
from piper_tpu_torch.models.vits import model as TM
from piper_tpu_torch.models.vits.model import init_synthesizer_params
from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config
from piper_tpu_torch.weights import onnx_loader as t_onnx
from piper_tpu_torch.weights import torch_export as t_export
from piper_tpu_torch.weights import torch_loader as t_torch
from piper_tpu_torch.weights.native import save_native
from torch_parity import TINY, TINY_MS, close, normal, tcfg


def _tiny(**kw):
    """tests/test_onnx_export.py's tiny_cfg."""
    base = dict(
        num_symbols=40, inter_channels=8, hidden_channels=16, filter_channels=24,
        n_heads=2, n_layers=2, kernel_size=3, resblock="2", resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 2),), upsample_rates=(4, 4),
        upsample_initial_channel=16, upsample_kernel_sizes=(8, 8), spec_channels=33,
    )
    base.update(kw)
    return ModelConfig(**base)


# The high preset's generator shape (resblock "1", rates 8-8-2-2) at
# narrow widths.
HIGH = ModelConfig(
    num_symbols=64, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, resblock="1", resblock_kernel_sizes=(3, 7, 11),
    resblock_dilation_sizes=((1, 3, 5),) * 3, upsample_rates=(8, 8, 2, 2),
    upsample_initial_channel=32, upsample_kernel_sizes=(16, 16, 4, 4),
    audio=AudioConfig(sample_rate=22050),
)

# test_onnx_export.py's three variants, then the same three on the
# presets' generator shapes (the only ones a loader can derive without a
# base config: kernel sizes and dilations are not in the tensors)
VARIANTS = {
    "single": _tiny(),
    "multi": _tiny(num_speakers=3, gin_channels=8),
    "resblock1": _tiny(resblock="1", resblock_kernel_sizes=(3, 5),
                       resblock_dilation_sizes=((1, 2), (1, 2))),
    "single_preset": TINY,
    "multi_preset": TINY_MS,
    "resblock1_preset": HIGH,
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_same_tree(got, ref):
    """Same keys, dtypes, shapes and bits."""
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
        assert g[k].tobytes() == r[k].tobytes(), k


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - both packages must fail alike
        return None, (type(e), str(e))


@pytest.fixture(scope="module")
def onnx_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    out = {}
    for i, (name, cfg) in enumerate(VARIANTS.items()):
        params = init_synthesizer_params(10 + i, tcfg(cfg))
        path = d / f"{name}.onnx"
        export_onnx_voice(params, cfg, str(path))
        out[name] = (path, cfg, params)
    return out


@pytest.mark.parametrize("base", [True, False], ids=["base_config", "no_base_config"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_onnx_loader_matches_jax(onnx_files, variant, base):
    path, cfg, params = onnx_files[variant]
    ref, ref_err = _outcome(lambda: j_onnx.load_onnx_voice(str(path), cfg if base else None))
    got, got_err = _outcome(lambda: t_onnx.load_onnx_voice(str(path), tcfg(cfg) if base else None))
    assert got_err == ref_err
    if variant.endswith("_preset") or base:
        assert ref_err is None, ref_err  # derivable: the comparison is not vacuous
    if ref_err is None:
        assert_same_tree(got[0], ref[0])
        assert got[1] == tcfg(ref[1])
        # and the export round-trips: every leaf the graph carries
        # (the reverse path drops the posterior and conv_flows[0])
        want = {k: v for k, v in _leaves(params).items()
                if ".post_" not in "." + k and "conv_flows.0." not in k}
        have = _leaves(got[0])
        for k, v in want.items():
            assert have[k].tobytes() == v.astype(np.float32).tobytes(), k


# -- a protobuf writer of just what the reader parses -----------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int, payload) -> bytes:
    tag = _varint(num << 3 | wire)
    if wire == 0:
        return tag + _varint(payload)
    if wire == 2:
        return tag + _varint(len(payload)) + payload
    return tag + payload  # fixed32 / fixed64: payload is the bytes


def _tensor(name, dims, data_type, *, raw=None, floats=None, int32s=None, int64s=None,
            packed=True, packed_dims=False):
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    int64_data=7, name=8, raw_data=9."""
    b = b""
    if packed_dims and dims:
        b += _field(1, 2, b"".join(_varint(d) for d in dims))
    else:
        b += b"".join(_field(1, 0, d) for d in dims)
    b += _field(2, 0, data_type) + _field(8, 2, name.encode())
    if raw is not None:
        b += _field(9, 2, raw)
    if floats is not None:
        f32 = np.asarray(floats, "<f4")
        b += (_field(4, 2, f32.tobytes()) if packed
              else b"".join(_field(4, 5, x.tobytes()) for x in f32))
    for num, vals in ((5, int32s), (7, int64s)):
        if vals is not None:
            b += (_field(num, 2, b"".join(_varint(int(v)) for v in vals)) if packed
                  else b"".join(_field(num, 0, int(v)) for v in vals))
    return b


def _node(inputs, outputs, op_type):
    return (b"".join(_field(1, 2, i.encode()) for i in inputs)
            + b"".join(_field(2, 2, o.encode()) for o in outputs)
            + _field(4, 2, op_type.encode()))


def _model(tensors, nodes=()):
    graph = b"".join(_field(1, 2, n) for n in nodes) + b"".join(_field(5, 2, t) for t in tensors)
    return _field(1, 0, 8) + _field(7, 2, graph)  # ir_version, graph


def test_onnx_reader_parses_every_dtype_and_field(tmp_path):
    """TensorProtos of every _DTYPES entry as raw_data, the typed
    float/int32/int64 fields packed and unpacked, packed dims, a rank-0
    scalar, an empty tensor and the node table: read alike."""
    assert t_onnx._DTYPES == j_onnx._DTYPES
    rng = np.random.default_rng(0)
    tensors = []
    for code, dt in j_onnx._DTYPES.items():
        arr = (np.abs(rng.standard_normal((2, 3))) * 50).astype(dt)
        tensors.append(_tensor(f"raw{code}", arr.shape, code, raw=arr.tobytes(),
                               packed_dims=code % 2 == 0))
    vals = rng.standard_normal(6).astype(np.float32)
    ints = rng.integers(0, 1000, 6)
    for packed in (True, False):
        tag = "packed" if packed else "unpacked"
        tensors += [
            _tensor(f"f_{tag}", (3, 2), 1, floats=vals, packed=packed),
            _tensor(f"i32_{tag}", (6,), 6, int32s=ints, packed=packed),
            _tensor(f"i64_{tag}", (2, 3), 7, int64s=ints, packed=packed),
        ]
    tensors += [_tensor("scalar", (), 1, floats=[2.5]), _tensor("empty", (0,), 1)]
    nodes = [_node(["x", "w", "dec.conv_pre.bias"], ["y"], "Conv"), _node(["y"], ["z"], "Tanh")]
    path = tmp_path / "fields.onnx"
    path.write_bytes(_model(tensors, nodes))
    ref_init, ref_nodes = j_onnx.read_onnx_initializers(str(path), with_nodes=True)
    got_init, got_nodes = t_onnx.read_onnx_initializers(str(path), with_nodes=True)
    assert got_nodes == ref_nodes and len(ref_nodes) == 2
    assert_same_tree(got_init, ref_init)
    assert len(ref_init) == len(j_onnx._DTYPES) + 8
    assert ref_init["scalar"].shape == () and ref_init["f_unpacked"].shape == (3, 2)
    assert_same_tree(t_onnx.read_onnx_initializers(str(path)), ref_init)


def _folded_tables(rng):
    """Initializers and nodes as torch.onnx leaves them: constant-folded
    weight-norm weights under onnx::Conv_N names beside module-named
    biases, and the SDP's ElementwiseAffine in its three folded forms."""
    c = 4
    init = {
        "onnx::Conv_7": normal(rng, (8, 4, 3)),  # -> dec.ups.0.weight
        "dec.ups.0.bias": normal(rng, (8,)),
        "onnx::Conv_9": normal(rng, (4, 4, 1)),  # bias prefix without a dot: kept
        "bias": normal(rng, (4,)),
        "flow.flows.0.enc.in_layers.0.weight": normal(rng, (8, 4, 5)),  # named: kept
        "flow.flows.0.enc.in_layers.0.bias": normal(rng, (8,)),
        "onnx::ConvTranspose_11": normal(rng, (4, 2, 4)),
        "dec.ups.1.bias": normal(rng, (2,)),
        # affine 0: Mul by a fully folded exp(-logs) constant
        "dp.flows.0.m": normal(rng, (c, 1)),
        "onnx::Mul_20": np.exp(-normal(rng, (c, 1))),
        # affine 1: Mul by Exp(initializer holding -logs)
        "q.flows.0.m": normal(rng, (c, 1)),
        "onnx::Neg_30": normal(rng, (c, 1)),
        # affine 2: logs == 0, the Mul elided
        "x.flows.0.m": normal(rng, (c, 1)),
        # affine 3: logs already named
        "y.flows.0.m": normal(rng, (c, 1)),
        "y.flows.0.logs": normal(rng, (c, 1)),
        "onnx::Shape_40": np.asarray([1, 2], np.int64),
    }
    nodes = [
        (["x0", "onnx::Conv_7", "dec.ups.0.bias"], ["c0"], "Conv"),
        (["x1", "onnx::Conv_9", "bias"], ["c1"], "Conv"),
        (["x2", "flow.flows.0.enc.in_layers.0.weight", "flow.flows.0.enc.in_layers.0.bias"], ["c2"], "Conv"),
        (["x3", "onnx::ConvTranspose_11", "dec.ups.1.bias"], ["c3"], "ConvTranspose"),
        (["x4", "onnx::Conv_7"], ["c4"], "Conv"),  # no bias: skipped
        (["z", "dp.flows.0.m"], ["s0"], "Sub"),
        (["s0", "onnx::Mul_20"], ["m0"], "Mul"),
        (["onnx::Neg_30"], ["e1"], "Exp"),
        (["z1", "q.flows.0.m"], ["s1"], "Sub"),
        (["e1", "s1"], ["m1"], "Mul"),
        (["z2", "x.flows.0.m"], ["s2"], "Sub"),
        (["s2", "q"], ["r2"], "Add"),
    ]
    return init, nodes


def test_recover_folded_names_matches_jax():
    init, nodes = _folded_tables(np.random.default_rng(1))
    ref = j_onnx._recover_folded_names(dict(init), nodes)
    got = t_onnx._recover_folded_names(dict(init), nodes)
    assert_same_tree(got, ref)
    # the recovery did happen
    assert "dec.ups.0.weight" in ref and "dec.ups.1.weight" in ref and "onnx::Conv_9" in ref
    for m in ("dp.flows.0", "q.flows.0", "x.flows.0"):
        assert m + ".logs" in ref
    assert not ref["x.flows.0.logs"].any()


@pytest.mark.parametrize("case", ["pruned", "partly_present", "no_sdp"])
def test_synthesize_pruned_sdp_flow_matches_jax(case):
    rng = np.random.default_rng(2)
    sd = {f"dp.flows.3.{k}": normal(rng, (4, 3)) for k in ("pre.weight", "pre.bias", "proj.weight")}
    sd["dp.flows.0.m"] = normal(rng, (4, 1))
    if case == "partly_present":
        sd["dp.flows.1.pre.bias"] = normal(rng, (4, 3))
    if case == "no_sdp":
        sd = {"dp.proj.weight": normal(rng, (2, 4, 1))}
    ref, got = dict(sd), dict(sd)
    j_onnx._synthesize_pruned_sdp_flow(ref)
    t_onnx._synthesize_pruned_sdp_flow(got)
    assert_same_tree(got, ref)
    if case != "no_sdp":
        assert "dp.flows.1.proj.weight" in ref


# -- state dicts and .ckpt -----------------------------------------------------


def _hyper_parameters(cfg: ModelConfig) -> dict:
    """The hyper_parameters piper_train's Lightning module saves."""
    d = dataclasses.asdict(cfg)
    keys = ("num_symbols", "num_speakers", "inter_channels", "hidden_channels",
            "filter_channels", "n_heads", "n_layers", "kernel_size", "p_dropout", "resblock",
            "resblock_kernel_sizes", "resblock_dilation_sizes", "upsample_rates",
            "upsample_initial_channel", "upsample_kernel_sizes", "gin_channels", "use_sdp")
    return {k: d[k] for k in keys}


def _posterior(rng, cfg: ModelConfig) -> dict:
    """enc_q tensors (training checkpoints carry the posterior encoder)."""
    h = cfg.hidden_channels
    sd = {"enc_q.pre.weight": normal(rng, (h, cfg.spec_channels, 1)),
          "enc_q.pre.bias": normal(rng, (h,)),
          "enc_q.proj.weight": normal(rng, (2 * cfg.inter_channels, h, 1)),
          "enc_q.proj.bias": normal(rng, (2 * cfg.inter_channels,))}
    for i in range(16):
        sd[f"enc_q.enc.in_layers.{i}.weight"] = normal(rng, (2 * h, h, 5))
        sd[f"enc_q.enc.in_layers.{i}.bias"] = normal(rng, (2 * h,))
        out = 2 * h if i < 15 else h
        sd[f"enc_q.enc.res_skip_layers.{i}.weight"] = normal(rng, (out, h, 1))
        sd[f"enc_q.enc.res_skip_layers.{i}.bias"] = normal(rng, (out,))
    return sd


@pytest.mark.parametrize("inference_only", [True, False])
@pytest.mark.parametrize("variant", ["single", "multi", "resblock1", "resblock1_preset"])
def test_state_dict_from_params_matches_jax(variant, inference_only):
    cfg = VARIANTS[variant]
    params = init_synthesizer_params(3, tcfg(cfg))
    ref = j_export.state_dict_from_params(params, cfg, inference_only=inference_only)
    got = t_export.state_dict_from_params(params, tcfg(cfg), inference_only=inference_only)
    assert list(got) == list(ref)
    assert_same_tree(got, ref)
    # the exact inverse of the loader: every leaf back, bit for bit
    # (an inference-only dict drops the SDP's posterior flows)
    back = _leaves(t_torch.params_from_state_dict(got, tcfg(cfg)))
    want = {k: v for k, v in _leaves(params).items()
            if not (inference_only and k.startswith("dp.post_"))}
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].tobytes() == v.astype(np.float32).tobytes(), k


def _weight_normed(sd: dict) -> dict:
    """sd with the convs piper_train wraps in weight_norm (the WN
    layers, the generator, the posterior) as (weight_g, weight_v) pairs,
    as its checkpoints hold them: v = W, g = ||W|| over dims != 0."""
    out = {}
    for k, w in sd.items():
        if k.endswith(".weight") and (".in_layers." in k or k.startswith(("dec.", "enc_q."))):
            base = k[: -len(".weight")]
            g = np.sqrt(np.sum(np.square(w), axis=tuple(range(1, w.ndim)), keepdims=True))
            out[base + ".weight_g"] = g.astype(np.float32)
            out[base + ".weight_v"] = w
        else:
            out[k] = w
    return out


@pytest.mark.parametrize("layout", ["lightning", "lightning_posterior", "raw"])
@pytest.mark.parametrize("variant", ["single_preset", "multi_preset", "resblock1_preset"])
def test_torch_checkpoint_loader_matches_jax(tmp_path, variant, layout):
    """.ckpt files read by both load_torch_checkpoint: the Lightning
    layout (model_g. prefix, ModelConfig from hyper_parameters, weight
    norm folded; once with the training-only posterior, read with
    include_posterior) and a raw state dict (an explicit ModelConfig, or
    the same ValueError without one)."""
    cfg = VARIANTS[variant]
    rng = np.random.default_rng(4)
    params = init_synthesizer_params(5, tcfg(cfg))
    posterior = layout == "lightning_posterior"
    sd = j_export.state_dict_from_params(params, cfg, inference_only=not posterior)
    if posterior:
        sd.update(_posterior(rng, cfg))
    path = tmp_path / "voice.ckpt"
    if layout == "raw":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        kw = [dict(cfg=cfg), dict()]
    else:
        torch.save({"state_dict": {"model_g." + k: torch.from_numpy(v)
                                   for k, v in _weight_normed(sd).items()},
                    "hyper_parameters": _hyper_parameters(cfg)}, path)
        kw = [dict(include_posterior=posterior)]
    for k in kw:
        tk = {**k, "cfg": tcfg(k["cfg"])} if "cfg" in k else k
        ref, ref_err = _outcome(lambda: j_torch.load_torch_checkpoint(str(path), **k))
        got, got_err = _outcome(lambda: t_torch.load_torch_checkpoint(str(path), **tk))
        assert got_err == ref_err
        if layout == "raw" and "cfg" not in k:
            assert ref_err is not None and ref_err[0] is ValueError
            continue
        assert ref_err is None, ref_err
        assert_same_tree(got[0], ref[0])
        assert got[1] == tcfg(ref[1])
        assert ("enc_q" in got[0]) == posterior


# -- TorchVoice.load and the audio ---------------------------------------------


@pytest.fixture(scope="module")
def voice_files(tmp_path_factory):
    """One set of weights (TINY: the medium generator's shape, narrow) as
    .npz, .onnx (the JAX package's exporter) and .ckpt (the port's
    state_dict_from_params in the Lightning layout), each with its JSON
    sidecar."""
    d = tmp_path_factory.mktemp("voices")
    cfg = tcfg(TINY)
    params = init_synthesizer_params(6, cfg)
    save_native(str(d / "voice.npz"), params, cfg)
    export_onnx_voice(params, TINY, str(d / "voice.onnx"))
    sd = t_export.state_dict_from_params(params, cfg)
    torch.save({"state_dict": {"model_g." + k: torch.from_numpy(v) for k, v in sd.items()},
                "hyper_parameters": _hyper_parameters(TINY)}, d / "voice.ckpt")
    sidecar = json.dumps(random_voice_config(cfg).to_dict())
    for ext in ("npz", "onnx"):
        (d / f"voice.{ext}.json").write_text(sidecar)
    (d / "voice.json").write_text(sidecar)  # the .ckpt's: <stem>.json
    return d, params


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_torch_voice_load_gives_the_same_bytes_in_every_format(voice_files, precision):
    d, _ = voice_files
    out = {}
    for ext in ("npz", "onnx", "ckpt"):
        voice = TorchVoice.load(d / f"voice.{ext}", device="cpu", precision=precision)
        out[ext] = (voice.synthesize("Hello world. A second sentence.",
                                     syn=_syn(seed=3)).tobytes(),
                    [a.tobytes() for a in voice.synthesize_ids_batch(
                        [[1, 0, 40, 0, 41, 0, 2], [1, 0] + [20 + i for i in range(30)] + [0, 2]],
                        syn=_syn(seed=4))])
    assert len(out["npz"][0]) > 0
    assert out["onnx"] == out["npz"] and out["ckpt"] == out["npz"]


def _syn(**kw):
    from piper_tpu_torch.config import SynthesisConfig

    return SynthesisConfig(**kw)


def test_torch_voice_load_refuses_other_formats(tmp_path):
    (tmp_path / "voice.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported voice format"):
        TorchVoice.load(tmp_path / "voice.pt", device="cpu")


def test_onnx_voice_audio_matches_jax_infer(voice_files):
    """The .onnx voice loaded by the port (TorchVoice.load, parity, CPU)
    against the JAX package's infer on the weights its own loader reads
    from the same file, the noise passed in explicitly."""
    d, _ = voice_files
    voice = TorchVoice.load(d / "voice.onnx", device="cpu", precision="parity")
    # the JAX package's TpuVoice.load passes the sidecar's preset as the base
    base = VoiceConfig.from_file(d / "voice.onnx.json").model_config()
    tree, jcfg = j_onnx.load_onnx_voice(str(d / "voice.onnx"), base)
    assert voice.model_cfg == tcfg(jcfg)
    rng = np.random.default_rng(8)
    lens = np.array([23, 11], np.int32)
    ids = np.zeros((2, 23), np.int32)
    for r, n in enumerate(lens):
        ids[r, :n] = [1] + [int(x) for x in rng.integers(3, TINY.num_symbols, n - 2)] + [2]
    max_frames = 160
    dur_noise = normal(rng, ids.shape + (2,))
    frame_noise = normal(rng, (2, max_frames, TINY.inter_channels))
    kw = dict(max_frames=max_frames, noise_scale=0.667, length_scale=1.0, noise_w_scale=0.8)
    ref, ref_len = JM.infer(
        tree, jnp.asarray(ids), jnp.asarray(lens), cfg=jcfg,
        dur_noise=jnp.asarray(dur_noise), frame_noise=jnp.asarray(frame_noise), **kw,
    )
    got, got_len = TM.infer(
        voice.params, torch.from_numpy(ids).long(), torch.from_numpy(lens), cfg=voice.model_cfg,
        dur_noise=torch.from_numpy(dur_noise), frame_noise=torch.from_numpy(frame_noise), **kw,
    )
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert int(got_len.min()) > 10
    u = TINY.upsample_factor
    for i, n in enumerate(np.asarray(ref_len)):
        close(got[i, : n * u], np.asarray(ref)[i, : n * u], atol=1e-4, rtol=0, what=f"row {i}")
