"""Serving runtime: voice loading, bucketed batched synthesis, WAV IO."""
