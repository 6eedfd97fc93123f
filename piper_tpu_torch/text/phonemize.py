"""Phonemization backends.

The reference delegates to the external piper-phonemize C++ library
(espeak-ng IPA phonemes or unicode-codepoint "text phonemes";
reference: src/python_run/piper/voice.py:57-70). Here:

- espeak backend: piper_phonemize wheel if installed, else a ctypes
  binding to libespeak-ng when present on the host. Both are gated —
  this container ships neither.
- codepoint backend: pure Python (NFD-normalize, casefold, split into
  codepoints), with regex sentence splitting.
- fixture backend: pre-phonemized {text -> phonemes} lookup, used by
  tests and demos (the reference ships the same fixtures:
  etc/test_sentences/test_*.jsonl).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional

from ..config import PhonemeType, VoiceConfig


class PhonemizerUnavailable(RuntimeError):
    """Raised when the espeak backend is requested but not installed."""


_SENTENCE_RE = re.compile(r"[^.!?…]+[.!?…]*\s*")


def split_sentences(text: str) -> List[str]:
    """Regex sentence segmentation (espeak performs this internally in
    the reference; this is the host-side equivalent for non-espeak
    backends)."""
    parts = [m.group(0).strip() for m in _SENTENCE_RE.finditer(text)]
    return [p for p in parts if p] or ([text.strip()] if text.strip() else [])


def phonemize_codepoints(text: str, *, casefold: bool = True) -> List[List[str]]:
    """Unicode-codepoint 'phonemes', one list per sentence.

    Matches piper-phonemize's text-phoneme behavior: NFD normalization
    and casefolding, each codepoint one phoneme.
    """
    out = []
    for sentence in split_sentences(text):
        if casefold:
            sentence = sentence.casefold()
        sentence = unicodedata.normalize("NFD", sentence)
        out.append(list(sentence))
    return out


# ---------------------------------------------------------------------------
# espeak-ng backend (gated)
# ---------------------------------------------------------------------------

_ESPEAK_LIB = None
_ESPEAK_INITIALIZED = False


def _load_espeak():
    global _ESPEAK_LIB
    if _ESPEAK_LIB is not None:
        return _ESPEAK_LIB
    for name in ("espeak-ng", "espeak"):
        path = ctypes.util.find_library(name)
        if path:
            _ESPEAK_LIB = ctypes.CDLL(path)
            return _ESPEAK_LIB
    raise PhonemizerUnavailable(
        "espeak phonemization requires the piper_phonemize wheel or "
        "libespeak-ng; neither is available. Use phoneme_type='text' "
        "voices, a fixture phonemizer, or pre-phonemized ids."
    )


# Clause punctuation piper-phonemize reports as terminators
# (reference: phonemize.cpp CLAUSE_* handling used by piper.cpp:508).
_CLAUSE_RE = re.compile(r"[^,.;:!?…]+|[,.;:!?…]")


def split_clauses(sentence: str) -> List[tuple]:
    """(clause_text, terminator_or_None, space_after) triples for one
    sentence. space_after records whether whitespace followed the
    terminator in the source text — piper-phonemize emits the ' '
    phoneme after a clause mark only when the text had one
    ("a, b" -> [',', ' '] but "a,b" -> [','])."""
    out: List[tuple] = []
    for m in _CLAUSE_RE.finditer(sentence):
        tok = m.group(0)
        if tok in ",.;:!?…":
            space_after = sentence[m.end():m.end() + 1].isspace()
            if out and out[-1][1] is None:
                out[-1] = (out[-1][0], tok, space_after)
            else:
                out.append(("", tok, space_after))
        elif tok.strip():
            out.append((tok.strip(), None, False))
    return out


def reconstruct_clause_phonemes(
    sentence: str, clause_ipa: List[str]
) -> List[str]:
    """Rebuild the piper-phonemize phoneme contract from per-clause
    stock-espeak IPA strings.

    The reference's patched espeak reports each clause's terminator
    (espeak_TextToPhonemesWithTerminator, piper.cpp:218-219), and
    piper-phonemize emits: word phonemes with single-space separators,
    the clause punctuation mark as a phoneme, then ' ' between clauses
    (fixtures: [... 'n', ',', ' ', 'ɹ', ...] ... ending '.'). Stock
    espeak_TextToPhonemes drops the punctuation, so the terminators
    are reconstructed here from the sentence TEXT instead — same
    information, taken from the input rather than a patched API.
    `clause_ipa[i]` is espeak's IPA for the i-th clause text from
    split_clauses."""
    clauses = split_clauses(sentence)
    phonemes: List[str] = []
    for i, ((_, term, space_after), ipa) in enumerate(
        zip(clauses, clause_ipa)
    ):
        # normalize espeak whitespace (chunks may carry newlines /
        # doubled separators) to the single-space word separator
        words = [w for w in ipa.split() if w]
        for j, w in enumerate(words):
            if j:
                phonemes.append(" ")
            phonemes.extend(w)  # one phoneme per codepoint
        if term is not None:
            phonemes.append(term)
            if space_after and i + 1 < len(clauses):
                phonemes.append(" ")
    return phonemes


def phonemize_espeak(text: str, voice: str) -> List[List[str]]:
    """IPA phonemes per sentence via espeak-ng.

    Prefers the piper_phonemize wheel (identical to the reference);
    falls back to a direct espeak-ng ctypes call per CLAUSE, with the
    clause terminators the patched reference espeak would report
    reconstructed from the input text (reconstruct_clause_phonemes).
    """
    try:
        import piper_phonemize  # type: ignore

        return piper_phonemize.phonemize_espeak(text, voice)
    except ImportError:
        pass

    lib = _load_espeak()
    global _ESPEAK_INITIALIZED
    if not _ESPEAK_INITIALIZED:
        # AUDIO_OUTPUT_SYNCHRONOUS=2, no audio path needed for phonemes
        if lib.espeak_Initialize(2, 0, None, 0) < 0:
            raise PhonemizerUnavailable("espeak_Initialize failed")
        _ESPEAK_INITIALIZED = True
    lib.espeak_SetVoiceByName(voice.encode())
    lib.espeak_TextToPhonemes.restype = ctypes.c_char_p

    results: List[List[str]] = []
    for sentence in split_sentences(text):
        clause_ipa = [
            _espeak_text_to_ipa(lib, clause)
            for clause, _, _ in split_clauses(sentence)
        ]
        results.append(reconstruct_clause_phonemes(sentence, clause_ipa))
    return results


def _espeak_text_to_ipa(lib, clause: str) -> str:
    """One stock espeak_TextToPhonemes call chain over a clause."""
    if not clause:
        return ""
    buf = ctypes.create_string_buffer(clause.encode("utf-8"))
    ptr = ctypes.cast(
        ctypes.pointer(ctypes.cast(buf, ctypes.c_void_p)),
        ctypes.POINTER(ctypes.c_void_p),
    )
    chunks = []
    while ptr.contents.value:
        # textmode=espeakCHARS_UTF8(1); phonememode 0x02 -> IPA
        chunk = lib.espeak_TextToPhonemes(ptr, 1, 0x02)
        if not chunk:
            break
        chunks.append(chunk.decode("utf-8"))
    return " ".join(chunks)


# ---------------------------------------------------------------------------
# Fixture phonemizer
# ---------------------------------------------------------------------------


class FixturePhonemizer:
    """text -> phonemes lookup loaded from a JSONL file of
    {"text", "phonemes", "phoneme_ids"} records."""

    def __init__(self, path: str | Path):
        self.by_text: Dict[str, List[str]] = {}
        self.ids_by_text: Dict[str, List[int]] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                self.by_text[rec["text"]] = rec["phonemes"]
                if "phoneme_ids" in rec:
                    self.ids_by_text[rec["text"]] = rec["phoneme_ids"]

    def __call__(self, text: str, voice: str = "") -> List[List[str]]:
        out = []
        for sentence in split_sentences(text):
            if sentence in self.by_text:
                out.append(list(self.by_text[sentence]))
            elif text in self.by_text:
                return [list(self.by_text[text])]
            else:
                raise KeyError(f"no fixture phonemes for: {sentence!r}")
        return out


def phonemize(
    text: str,
    config: VoiceConfig,
    *,
    backend: Optional[object] = None,
) -> List[List[str]]:
    """Phonemize per the voice config (reference: voice.py:57-70).

    `backend` overrides the espeak path (e.g. a FixturePhonemizer).
    """
    if backend is not None:
        return backend(text, config.espeak_voice)  # type: ignore[operator]
    if config.phoneme_type == PhonemeType.TEXT:
        return phonemize_codepoints(text)
    if config.espeak_voice == "ar":
        text = _tashkeel(text)
    return phonemize_espeak(text, config.espeak_voice)


def _tashkeel(text: str) -> str:
    """Arabic diacritization (reference: voice.py:60-63). Gated on the
    piper_phonemize wheel; identity otherwise."""
    try:
        import piper_phonemize  # type: ignore

        return piper_phonemize.tashkeel_run(text)
    except ImportError:
        return text
