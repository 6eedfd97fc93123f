"""Dataset QA tools and voice conversion (counterparts of the JAX
package's piper_tpu/tools/: filter_utterances, check_phonemes,
clean_cached_audio, select_speaker, make_registry, voice_conversion)."""
