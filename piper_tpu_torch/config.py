"""Voice / model / synthesis configuration.

Mirrors the contract of the reference voice JSON config
(reference: src/python_run/piper/config.py:38-53 and TRAINING.md:53-96)
and the model hyperparameter presets
(reference: src/python/piper_train/vits/lightning.py:20-77,
src/python/piper_train/__main__.py:68-82), re-expressed as typed
dataclasses. A copy of piper_tpu/config.py, kept in this package so the
PyTorch port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union


class PhonemeType(str, Enum):
    ESPEAK = "espeak"
    TEXT = "text"


class Quality(str, Enum):
    X_LOW = "x-low"
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"


@dataclass(frozen=True)
class AudioConfig:
    """Audio/STFT parameters (reference: vits/config.py:6-26)."""

    sample_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    quality: Optional[str] = None


@dataclass(frozen=True)
class ModelConfig:
    """VITS architecture hyperparameters.

    Defaults are the reference's medium/low quality settings
    (reference: vits/lightning.py:26-58).
    """

    num_symbols: int = 256
    num_speakers: int = 1

    # Text encoder / shared
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1

    # HiFiGAN generator
    resblock: str = "2"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 5, 7)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 2), (2, 6), (3, 12))
    upsample_rates: Tuple[int, ...] = (8, 8, 4)
    upsample_initial_channel: int = 256
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8)

    # Posterior encoder (training)
    spec_channels: int = 513
    segment_size: int = 8192  # samples; frames = segment_size // hop_length

    # Speaker conditioning
    gin_channels: int = 0
    use_sdp: bool = True

    # Flow
    flow_kernel_size: int = 5
    flow_n_layers: int = 4
    flow_n_flows: int = 4

    # Vocoder head: "hifigan" (reference parity) or "mb_istft"
    # (multi-band iSTFT variant, see models/vits/istft_generator.py)
    vocoder: str = "hifigan"
    subbands: int = 4
    istft_n_fft: int = 16
    istft_hop: int = 4

    # VITS2 architecture upgrades (arXiv:2307.16430; beyond the
    # reference, which is VITS1):
    # - flow_transformer: windowed self-attention block inside each
    #   residual-coupling conditioner (long-range deps in the flow).
    # - use_dur_disc: adversarial duration training — a per-position
    #   discriminator on (text hidden, log-duration) pairs.
    # - mas_noise: Gaussian noise added to the MAS alignment scores
    #   during training (annealed by the train loop).
    # - speaker_cond_encoder: condition the text encoder itself on the
    #   speaker embedding (multi-speaker).
    flow_transformer: bool = False
    use_dur_disc: bool = False
    mas_noise: bool = False
    speaker_cond_encoder: bool = False

    audio: AudioConfig = field(default_factory=AudioConfig)

    @staticmethod
    def vits2(
        quality: str = "medium", num_symbols: int = 256, **kw
    ) -> "ModelConfig":
        """VITS2 preset: VITS quality presets + the 2307.16430 upgrades."""
        base = ModelConfig.for_quality(quality, num_symbols=num_symbols, **kw)
        return dataclasses.replace(
            base,
            flow_transformer=True,
            use_dur_disc=True,
            mas_noise=True,
            speaker_cond_encoder=base.num_speakers > 1,
        )

    @property
    def upsample_factor(self) -> int:
        f = 1
        for u in self.upsample_rates:
            f *= u
        if self.vocoder == "mb_istft":
            f *= self.istft_hop * self.subbands
        return f

    @staticmethod
    def mb_istft(
        quality: str = "medium", num_symbols: int = 256, **kw
    ) -> "ModelConfig":
        """MB-iSTFT vocoder preset: shortened conv stack (4x4) +
        iSTFT hop 4 x 4 subbands = 256x total upsampling."""
        base = ModelConfig.for_quality(quality, num_symbols=num_symbols, **kw)
        return dataclasses.replace(
            base,
            vocoder="mb_istft",
            upsample_rates=(4, 4),
            upsample_kernel_sizes=(8, 8),
        )

    @staticmethod
    def for_quality(
        quality: Union[str, Quality],
        num_symbols: int,
        num_speakers: int = 1,
        gin_channels: int = 0,
    ) -> "ModelConfig":
        """Quality presets (reference: piper_train/__main__.py:68-82)."""
        quality = Quality(quality)
        if num_speakers > 1 and gin_channels <= 0:
            gin_channels = 512  # reference: lightning.py:81-83
        common: Dict[str, Any] = dict(
            num_symbols=num_symbols,
            num_speakers=num_speakers,
            gin_channels=gin_channels,
        )
        if quality == Quality.X_LOW:
            return ModelConfig(
                hidden_channels=96,
                inter_channels=96,
                filter_channels=384,
                audio=AudioConfig(sample_rate=16000, quality="x-low"),
                **common,
            )
        if quality == Quality.HIGH:
            return ModelConfig(
                resblock="1",
                resblock_kernel_sizes=(3, 7, 11),
                resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                upsample_rates=(8, 8, 2, 2),
                upsample_initial_channel=512,
                upsample_kernel_sizes=(16, 16, 4, 4),
                audio=AudioConfig(sample_rate=22050, quality="high"),
                **common,
            )
        sr = 16000 if quality == Quality.LOW else 22050
        return ModelConfig(
            audio=AudioConfig(sample_rate=sr, quality=quality.value), **common
        )


@dataclass(frozen=True)
class InferenceDefaults:
    """Default synthesis scales (reference: config.py:47-50)."""

    noise_scale: float = 0.667
    length_scale: float = 1.0
    noise_w: float = 0.8


@dataclass
class SynthesisConfig:
    """Per-request synthesis controls (reference: piper.hpp:60-82)."""

    speaker_id: Optional[int] = None
    noise_scale: Optional[float] = None
    length_scale: Optional[float] = None
    noise_w: Optional[float] = None
    sentence_silence_seconds: float = 0.2
    # phoneme -> seconds of silence inserted after it
    phoneme_silence_seconds: Optional[Dict[str, float]] = None
    volume: float = 1.0
    seed: Optional[int] = None
    # Admission-queue controls (server batching; no device effect).
    # Lower priority dispatches sooner; ties are FIFO. deadline_s bounds
    # the time a request may wait in the admission queue before being
    # shed with DeadlineExceeded (never cancels in-flight device work).
    priority: int = 0
    deadline_s: Optional[float] = None


@dataclass
class VoiceConfig:
    """Parsed voice JSON config — the cross-implementation contract.

    Schema parity with reference: src/python_run/piper/config.py:38-53,
    src/cpp/piper.cpp:47-214, TRAINING.md:53-96.
    """

    num_symbols: int
    num_speakers: int
    sample_rate: int
    espeak_voice: str
    inference: InferenceDefaults
    phoneme_id_map: Mapping[str, Sequence[int]]
    phoneme_type: PhonemeType = PhonemeType.ESPEAK
    phoneme_map: Mapping[str, Sequence[str]] = field(default_factory=dict)
    speaker_id_map: Mapping[str, int] = field(default_factory=dict)
    phoneme_silence_seconds: Optional[Dict[str, float]] = None
    language_code: Optional[str] = None
    dataset: Optional[str] = None
    audio: AudioConfig = field(default_factory=AudioConfig)
    piper_version: Optional[str] = None
    raw: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(config: Dict[str, Any]) -> "VoiceConfig":
        inference = config.get("inference", {})
        audio_cfg = config.get("audio", {})
        sample_rate = int(audio_cfg.get("sample_rate", 22050))
        language = config.get("language", {})
        return VoiceConfig(
            num_symbols=int(config["num_symbols"]),
            num_speakers=int(config.get("num_speakers", 1)),
            sample_rate=sample_rate,
            espeak_voice=config.get("espeak", {}).get("voice", "en-us"),
            inference=InferenceDefaults(
                noise_scale=float(inference.get("noise_scale", 0.667)),
                length_scale=float(inference.get("length_scale", 1.0)),
                noise_w=float(inference.get("noise_w", 0.8)),
            ),
            phoneme_id_map=config["phoneme_id_map"],
            phoneme_type=PhonemeType(config.get("phoneme_type", "espeak")),
            phoneme_map=config.get("phoneme_map", {}) or {},
            speaker_id_map=config.get("speaker_id_map", {}) or {},
            phoneme_silence_seconds=(
                {str(k): float(v) for k, v in inference["phoneme_silence"].items()}
                if "phoneme_silence" in inference
                else None
            ),
            language_code=language.get("code") if isinstance(language, dict) else None,
            dataset=config.get("dataset"),
            audio=AudioConfig(
                sample_rate=sample_rate, quality=audio_cfg.get("quality")
            ),
            piper_version=config.get("piper_version"),
            raw=config,
        )

    @staticmethod
    def from_file(path: Union[str, Path]) -> "VoiceConfig":
        with open(path, "r", encoding="utf-8") as f:
            return VoiceConfig.from_dict(json.load(f))

    def model_config(self) -> ModelConfig:
        """Derive the architecture config for this voice."""
        quality = self.audio.quality or (
            "medium" if self.sample_rate >= 22050 else "low"
        )
        # x_low voices (hidden 96) are identified by quality tag.
        mc = ModelConfig.for_quality(
            quality if quality in ("x-low", "high") else
            ("low" if self.sample_rate < 22050 else "medium"),
            num_symbols=self.num_symbols,
            num_speakers=self.num_speakers,
        )
        return dataclasses.replace(
            mc, audio=dataclasses.replace(mc.audio, sample_rate=self.sample_rate)
        )

    def to_dict(self) -> Dict[str, Any]:
        """Serialize back to the voice JSON schema."""
        d: Dict[str, Any] = dict(self.raw) if self.raw else {}
        d.update(
            {
                "audio": {
                    "sample_rate": self.sample_rate,
                    **({"quality": self.audio.quality} if self.audio.quality else {}),
                },
                "espeak": {"voice": self.espeak_voice},
                "inference": {
                    "noise_scale": self.inference.noise_scale,
                    "length_scale": self.inference.length_scale,
                    "noise_w": self.inference.noise_w,
                },
                "phoneme_type": self.phoneme_type.value,
                "phoneme_id_map": self.phoneme_id_map,
                "phoneme_map": self.phoneme_map,
                "num_symbols": self.num_symbols,
                "num_speakers": self.num_speakers,
                "speaker_id_map": self.speaker_id_map,
            }
        )
        return d
