"""Host-side text front end: phonemization and phoneme-id mapping.

Everything here runs on CPU and produces pre-tokenized int32 id
streams for the device (SURVEY.md §7 guiding decision).
"""

from .phonemes import BOS, EOS, PAD, phonemes_to_ids  # noqa: F401
from .phonemize import phonemize  # noqa: F401
