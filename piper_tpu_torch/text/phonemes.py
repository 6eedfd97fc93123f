"""Phoneme -> id mapping.

Parity: piper-phonemize's phonemes_to_ids as used by the reference C++
runtime (src/cpp/piper.cpp:555), training preprocessing, and the
shipped fixtures (etc/test_sentences/test_*.jsonl): ids are
[BOS, PAD] + [id, PAD] per phoneme + [EOS].

Note the reference's *Python* stack (src/python_run/piper/voice.py:
72-87) omits the PAD right after BOS — a divergence between the two
reference stacks. We default to the C++/fixture form (what released
voices were trained on) and expose `pad_after_bos=False` for the
python-piper variant.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional, Sequence

_LOGGER = logging.getLogger(__name__)

PAD = "_"  # id 0
BOS = "^"  # id 1
EOS = "$"  # id 2


def phonemes_to_ids(
    phonemes: Sequence[str],
    id_map: Mapping[str, Sequence[int]],
    *,
    phoneme_map: Optional[Mapping[str, Sequence[str]]] = None,
    missing: Optional[Dict[str, int]] = None,
    pad_after_bos: bool = True,
) -> List[int]:
    """Map phonemes to model ids with BOS/EOS and interspersed PAD.

    `phoneme_map` is the optional phoneme->phonemes rewrite applied
    before id lookup (reference: piper.cpp:141-160 parses it; applied
    by piper-phonemize's id conversion).
    """
    if phoneme_map:
        expanded: List[str] = []
        for ph in phonemes:
            if ph in phoneme_map:
                expanded.extend(phoneme_map[ph])
            else:
                expanded.append(ph)
        phonemes = expanded

    ids: List[int] = list(id_map[BOS])
    if pad_after_bos:
        ids.extend(id_map[PAD])
    for ph in phonemes:
        if ph not in id_map:
            _LOGGER.warning("Missing phoneme from id map: %s", ph)
            if missing is not None:
                missing[ph] = missing.get(ph, 0) + 1
            continue
        ids.extend(id_map[ph])
        ids.extend(id_map[PAD])
    ids.extend(id_map[EOS])
    return ids
