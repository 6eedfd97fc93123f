"""The port's ONNX writer, exporter, interpreter and export CLI against the
JAX package's, on the CPU: the writer's bytes for the same GraphBuilder
calls; export_onnx_voice's bytes on the same numpy weights (SDP,
deterministic duration predictor, and two speakers with resblock "1");
the interpreter's outputs on those files (bit for bit: the same numpy
code); the port's export run by its interpreter against the port's own
infer with zero noise (atol 5e-5, as tests/test_onnx_export.py holds the
JAX package's); the export through the port's loader to the .npz's
audio; the refusals of MB-iSTFT and VITS2 voices; and python -m
piper_tpu_torch.export for .npz -> .onnx, .npz -> .npz and
.ckpt --include-posterior -> .npz against python -m piper_tpu.export.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from piper_tpu import export as j_export_cli
from piper_tpu.onnx_io import export_onnx_voice as j_export
from piper_tpu.onnx_io import interp as JI
from piper_tpu.onnx_io import writer as JW
from piper_tpu_torch import export as t_export_cli
from piper_tpu_torch.models.vits import model as TM
from piper_tpu_torch.onnx_io import export_onnx_voice as t_export
from piper_tpu_torch.onnx_io import interp as TI
from piper_tpu_torch.onnx_io import writer as TW
from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config
from torch_parity import TINY, TINY_MS, jax_params, np_tree, port_params, tcfg

CONFIGS = {
    "sdp": TINY,
    "deterministic_dp": dataclasses.replace(TINY, use_sdp=False),
    "multispeaker_resblock1": dataclasses.replace(
        TINY_MS, resblock="1", resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    ),
}
IDS = np.array([[1, 0, 9, 0, 21, 0, 7, 0, 33, 0, 2]], np.int64)


def _build(mod):
    """The same GraphBuilder calls on either package's writer: every
    attribute type, deduplicated constants, named initializers, dynamic
    and fixed dims, a doc string."""
    b = mod.GraphBuilder("g")
    x = b.add_input("x", mod.FLOAT, ["B", 3, None])
    b.add_input("n", mod.INT64, [2])
    w = b.init("w", np.arange(12, dtype=np.float32).reshape(4, 3, 1))
    y = b.node("Conv", [x, w], pads=[0, 0], dilations=[1], strides=[1], group=1)
    y = b.node("LeakyRelu", [y], alpha=0.1)
    y = b.node("Mul", [y, b.f32(0.5)])
    y = b.node("Add", [y, b.f32(0.5)])  # deduplicated constant
    y = b.node("Reshape", [y, b.i64([0, -1])])
    y = b.node("Cast", [y], to=mod.FLOAT)
    b.node("ConstantOfShape", [b.i64([2])], value=np.array([1.5], np.float32))
    b.node("Softmax", [y], axis=-1, out=["out"])
    b.node("Identity", ["n"], note="a string", flag=True, scales=[0.25, 0.5])
    b.add_output("out", mod.FLOAT, ["B", None])
    return b.serialize(doc="writer test")


def test_writer_bytes_equal_jax():
    got, ref = _build(TW), _build(JW)
    assert got == ref and len(got) > 100


@pytest.fixture(scope="module")
def exports():
    """{config: (tree, port bytes, JAX bytes)}, one tree each."""
    out = {}
    for i, (name, jcfg) in enumerate(CONFIGS.items()):
        tree = jax_params(jcfg, 30 + i)
        out[name] = (tree, t_export(tree, tcfg(jcfg)), j_export(tree, jcfg))
    return out


def _feeds(jcfg, scales, sid=1):
    feeds = {"input": IDS, "input_lengths": np.array([IDS.shape[1]], np.int64),
             "scales": np.array(scales, np.float32)}
    if jcfg.num_speakers > 1:
        feeds["sid"] = np.array([sid], np.int64)
    return feeds


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_bytes_equal_jax(exports, name):
    _, got, ref = exports[name]
    assert got == ref
    model = TI.OnnxModel(got)
    assert model.input_names == ["input", "input_lengths", "scales"] + (
        ["sid"] if CONFIGS[name].num_speakers > 1 else [])
    assert model.output_names == ["output"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_interpreter_runs_equal_jax(exports, name):
    """Noise on (scales 0.667, 1, 0.8): both interpreters draw their
    RandomNormalLike values from the same numpy generator."""
    _, data, _ = exports[name]
    feeds = _feeds(CONFIGS[name], [0.667, 1.0, 0.8])
    got = TI.run(TI.OnnxModel(data), feeds, rng=np.random.default_rng(7))[0]
    ref = JI.run(JI.OnnxModel(data), feeds, rng=np.random.default_rng(7))[0]
    assert got.shape[:2] == (1, 1) and got.shape[2] > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_equals_port_infer_without_noise(exports, name):
    """The port's export under the port's interpreter against the port's
    infer (zero noise), within 5e-5 as tests/test_onnx_export.py:46
    holds the JAX package's export against its infer."""
    tree, data, _ = exports[name]
    jcfg = CONFIGS[name]
    cfg = tcfg(jcfg)
    wav = TI.run(TI.OnnxModel(data), _feeds(jcfg, [0.0, 1.0, 0.0]))[0]
    max_frames = 256
    sid = torch.tensor([1]) if jcfg.num_speakers > 1 else None
    with torch.inference_mode():
        audio, y_len = TM.infer(
            port_params(tree, jcfg), torch.from_numpy(IDS), torch.tensor([IDS.shape[1]]),
            cfg=cfg, max_frames=max_frames, noise_scale=0.0, length_scale=1.0,
            noise_w_scale=0.0, dur_noise=torch.zeros(1, IDS.shape[1], 2),
            frame_noise=torch.zeros(1, max_frames, cfg.inter_channels), sid=sid,
        )
    n = int(y_len[0]) * cfg.upsample_factor
    assert wav.shape == (1, 1, n)
    np.testing.assert_allclose(wav[0, 0], audio[0, :n].numpy(), atol=5e-5, rtol=0)


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_export_round_trips_to_the_npz_audio(tmp_path, precision):
    """The port's .onnx of a three-speaker voice through the port's
    loader (TorchVoice.load: a whole exported graph, its nodes parsed
    beside the initializers and its anonymous constants dropped, the
    architecture from the tensors over the sidecar's preset, here the
    medium generator's shape) gives the .npz's audio, bit for bit, on
    the CPU."""
    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.weights.native import save_native

    tree = jax_params(TINY_MS, 41)
    cfg = tcfg(TINY_MS)
    t_export(tree, cfg, str(tmp_path / "voice.onnx"))
    save_native(str(tmp_path / "voice.npz"), tree, cfg)
    sidecar = json.dumps(random_voice_config(cfg).to_dict())
    rows = [[1, 0, 40, 0, 41, 0, 2], [1, 0] + [20 + i for i in range(30)] + [0, 2]]
    out = {}
    for ext in ("onnx", "npz"):
        (tmp_path / f"voice.{ext}.json").write_text(sidecar)
        voice = TorchVoice.load(tmp_path / f"voice.{ext}", device="cpu", precision=precision)
        out[ext] = [a.tobytes() for a in voice.synthesize_ids_batch(
            rows, syn=SynthesisConfig(seed=5, speaker_id=2))]
    assert out["onnx"] == out["npz"] and all(len(a) for a in out["npz"])


@pytest.mark.parametrize("change", [
    dict(vocoder="mb_istft", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8)),
    dict(flow_transformer=True),
    dict(speaker_cond_encoder=True),
])
def test_export_refuses_what_jax_refuses(exports, change):
    tree = exports["sdp"][0]
    jcfg = dataclasses.replace(TINY, **change)
    with pytest.raises(ValueError, match="reference architecture only") as got:
        t_export(tree, tcfg(jcfg))
    with pytest.raises(ValueError) as ref:
        j_export(tree, jcfg)
    assert str(got.value) == str(ref.value)


def _hyper_parameters(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    keys = ("num_symbols", "num_speakers", "inter_channels", "hidden_channels",
            "filter_channels", "n_heads", "n_layers", "kernel_size", "p_dropout", "resblock",
            "resblock_kernel_sizes", "resblock_dilation_sizes", "upsample_rates",
            "upsample_initial_channel", "upsample_kernel_sizes", "gin_channels", "use_sdp")
    return {k: d[k] for k in keys}


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, exports):
    """A .npz voice with its sidecar, and a two-speaker training
    checkpoint (.ckpt in piper_train's Lightning layout, with enc_q)."""
    from piper_tpu.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.weights.native import save_native
    from piper_tpu_torch.weights.torch_export import state_dict_from_params

    d = tmp_path_factory.mktemp("cli")
    tree = exports["sdp"][0]
    cfg = tcfg(TINY)
    save_native(str(d / "voice.npz"), tree, cfg)
    (d / "voice.npz.json").write_text(json.dumps(random_voice_config(cfg).to_dict()))
    train_tree = np_tree(init_synthesizer_params(jax.random.PRNGKey(40), TINY_MS, training=True))
    sd = state_dict_from_params(train_tree, tcfg(TINY_MS), inference_only=False)
    assert any(k.startswith("enc_q.") for k in sd)
    torch.save({"state_dict": {"model_g." + k: torch.from_numpy(v) for k, v in sd.items()},
                "hyper_parameters": _hyper_parameters(TINY_MS)}, d / "train.ckpt")
    return d


def _npz_contents(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", ["npz_to_onnx", "npz_to_npz", "ckpt_posterior_to_npz"])
def test_export_cli_equals_jax(cli_inputs, tmp_path, case):
    d = cli_inputs
    src, fmt, extra = {
        "npz_to_onnx": (d / "voice.npz", "onnx", []),
        "npz_to_npz": (d / "voice.npz", "npz", []),
        "ckpt_posterior_to_npz": (d / "train.ckpt", "npz", ["--include-posterior"]),
    }[case]
    out = {}
    for name, main in (("port", t_export_cli.main), ("jax", j_export_cli.main)):
        path = tmp_path / f"{name}.{fmt}"
        main(["--input", str(src), "--output", str(path), "--format", fmt, *extra])
        out[name] = path
    if fmt == "onnx":
        assert out["port"].read_bytes() == out["jax"].read_bytes()
    else:
        got, ref = _npz_contents(out["port"]), _npz_contents(out["jax"])
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert any(k.startswith("enc_q.") for k in got) == (case == "ckpt_posterior_to_npz")
    sidecar = src.with_suffix(src.suffix + ".json")
    for path in out.values():
        copied = path.with_suffix(path.suffix + ".json")
        assert copied.exists() == sidecar.exists()
        if sidecar.exists():
            assert copied.read_bytes() == sidecar.read_bytes()


@pytest.mark.parametrize("fmt", ["torchscript", "generator"])
def test_export_cli_refuses_the_torch_formats(cli_inputs, tmp_path, fmt):
    with pytest.raises(SystemExit, match="piper_train") as e:
        t_export_cli.main(["--input", str(cli_inputs / "voice.npz"),
                           "--output", str(tmp_path / "voice.pt"), "--format", fmt])
    assert e.value.code != 0
    assert not (tmp_path / "voice.pt").exists()
