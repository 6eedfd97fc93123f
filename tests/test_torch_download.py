"""Voice names in the port, offline, on the CPU: the port's
runtime/download.py on tests/test_download.py's five cases, its
embedded registry against the JAX package's, and the CLI and the
benchmark CLI resolving a registry name (and an alias) to files in a
data dir with urlopen made to fail the test if it is called. An unknown
name, and a name whose files are missing with no network, exit with the
JAX package's messages."""

import io
import json
import sys
from urllib.error import URLError

import numpy as np
import pytest

from piper_tpu.onnx_io import export_onnx_voice
from piper_tpu.runtime import download as j_download
from piper_tpu_torch import __main__ as cli
from piper_tpu_torch.models.vits.model import init_synthesizer_params
from piper_tpu_torch.runtime import download as D
from piper_tpu_torch.runtime.download import (
    VoiceNotFoundError,
    ensure_voice_exists,
    find_voice,
    get_file_hash,
    get_voices,
)
from piper_tpu_torch.runtime.voice import random_voice_config
from torch_parity import TINY, tcfg


@pytest.fixture
def no_network(monkeypatch):
    """urlopen fails the test: every case here must resolve offline."""

    def urlopen(*a, **k):
        pytest.fail(f"network call: urlopen{a}")

    monkeypatch.setattr(D, "urlopen", urlopen)


def test_embedded_registry_resolves_offline(tmp_path, no_network):
    voices = get_voices(tmp_path)  # no cached copy, no update -> embedded
    assert len(voices) >= 97
    info = voices["en_US-lessac-medium"]
    assert info["language"]["code"] == "en_US"
    assert info["quality"] == "medium"
    onnx_files = [p for p in info["files"] if p.endswith(".onnx")]
    assert len(onnx_files) == 1
    meta = info["files"][onnx_files[0]]
    assert meta["size_bytes"] > 1_000_000
    assert len(meta["md5_digest"]) == 32
    # a multi-speaker voice keeps its speaker count
    assert voices["en_US-libritts-high"]["num_speakers"] > 1
    # the port's copy of the snapshot and of expand() give the JAX registry
    assert voices == j_download.get_voices(tmp_path)


def test_cached_registry_preferred(tmp_path, no_network):
    (tmp_path / "voices.json").write_text('{"fake-voice": {"files": {}}}')
    voices = get_voices(tmp_path)
    assert list(voices) == ["fake-voice"]


def test_ensure_voice_exists_validates_local_files(tmp_path, no_network):
    """A voice whose files are present with correct size+md5 needs no
    network: ensure_voice_exists returns without touching urlopen."""
    payload = b"x" * 128
    (tmp_path / "tiny.onnx").write_bytes(payload)
    voices_info = {
        "tiny": {
            "files": {
                "lang/tiny.onnx": {
                    "size_bytes": len(payload),
                    "md5_digest": get_file_hash(tmp_path / "tiny.onnx"),
                }
            }
        }
    }
    ensure_voice_exists("tiny", [tmp_path], tmp_path, voices_info)


def test_ensure_voice_exists_unknown_name(tmp_path):
    with pytest.raises(VoiceNotFoundError):
        ensure_voice_exists("nope", [tmp_path], tmp_path, {})


def test_find_voice(tmp_path):
    (tmp_path / "v.onnx").write_bytes(b"")
    (tmp_path / "v.onnx.json").write_text("{}")
    model, cfg = find_voice("v", [tmp_path])
    assert model.name == "v.onnx" and cfg.name == "v.onnx.json"
    with pytest.raises(VoiceNotFoundError):
        find_voice("missing", [tmp_path])


@pytest.fixture(scope="module")
def named_voice(tmp_path_factory):
    """A voice in the registry's layout (<name>.onnx and <name>.onnx.json,
    written by the JAX package's exporter) and a cached voices.json that
    lists it by size and md5, with an alias."""
    d = tmp_path_factory.mktemp("data")
    cfg = tcfg(TINY)
    export_onnx_voice(init_synthesizer_params(2, cfg), TINY, str(d / "xx_XX-tiny-low.onnx"))
    (d / "xx_XX-tiny-low.onnx.json").write_text(json.dumps(random_voice_config(cfg).to_dict()))
    files = {
        f"xx/xx_XX/tiny/low/{f.name}": {"size_bytes": f.stat().st_size, "md5_digest": get_file_hash(f)}
        for f in sorted(d.iterdir())
    }
    registry = {"xx_XX-tiny-low": {"key": "xx_XX-tiny-low", "language": {"code": "xx_XX"},
                                   "quality": "low", "num_speakers": 1, "aliases": ["tiny"],
                                   "files": files}}
    (d / "voices.json").write_text(json.dumps(registry))
    return d


def _run_cli(argv, stdin, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    cli.main(argv)


@pytest.mark.parametrize("name", ["xx_XX-tiny-low", "tiny"])
def test_cli_resolves_a_registry_name_offline(named_voice, name, tmp_path, monkeypatch, no_network):
    """-m NAME (or its alias) with the files in the working directory, the
    default --data-dir and download dir: the same WAV as -m PATH."""
    monkeypatch.chdir(named_voice)
    by_name, by_path = tmp_path / "name.wav", tmp_path / "path.wav"
    _run_cli(["-m", name, "-f", str(by_name), "--seed", "1", "--device", "cpu", "-q",
              "--pack-total", "pow2"], "Hello world.\n", monkeypatch)
    _run_cli(["-m", str(named_voice / "xx_XX-tiny-low.onnx"), "-f", str(by_path), "--seed", "1",
              "--device", "cpu", "-q"], "Hello world.\n", monkeypatch)
    assert by_name.read_bytes() == by_path.read_bytes() and len(by_path.read_bytes()) > 44


def test_benchmark_resolves_a_registry_name_offline(named_voice, tmp_path, monkeypatch, capsys,
                                                    no_network):
    """The benchmark CLI and the server load through the CLI's load_voice:
    -m NAME with --data-dir and --download-dir elsewhere than the working
    directory."""
    from piper_tpu_torch import benchmark

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps({"phoneme_ids": [1, 0, 40, 0, 41, 0, 2]})))
    benchmark.main(["-m", "tiny", "--data-dir", str(named_voice), "--download-dir", str(named_voice),
                    "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(report["rtfs"]) == 1 and report["load_sec"] > 0
    # the server parses with the CLI's build_parser and loads with load_voice
    args = cli.build_parser().parse_args(["-m", "tiny", "--data-dir", str(named_voice),
                                          "--download-dir", str(named_voice), "--device", "cpu"])
    voice = cli.load_voice(args)
    assert args.model.name == "xx_XX-tiny-low.onnx" and voice.config.num_symbols == TINY.num_symbols


def test_cli_unknown_name_exits_with_the_jax_message(tmp_path, monkeypatch, no_network):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        _run_cli(["-m", "no-such-voice", "--device", "cpu"], "Hi.\n", monkeypatch)
    assert str(e.value) == (
        "Voice 'no-such-voice' is not a local file and is not in the voices.json registry. "
        "Check the name or pass a path to a .npz/.ckpt/.onnx voice."
    )


def test_cli_missing_files_without_network_exits_with_the_jax_message(tmp_path, monkeypatch):
    """A registry name whose files are not in the data dirs needs a
    download; with the network unreachable the CLI exits, as the JAX
    package's does."""
    def urlopen(*a, **k):
        raise URLError("unreachable")

    monkeypatch.setattr(D, "urlopen", urlopen)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        _run_cli(["-m", "en_US-lessac-medium", "--device", "cpu"], "Hi.\n", monkeypatch)
    assert str(e.value) == (
        "Voice 'en_US-lessac-medium' is not a local file and the voice registry could not be "
        "reached (<urlopen error unreachable>). Pass a path to a local voice, or place "
        "voices.json in the download dir."
    )
    assert np.all([not p.name.endswith(".onnx") for p in tmp_path.iterdir()])
