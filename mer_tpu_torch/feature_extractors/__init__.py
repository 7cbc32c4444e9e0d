"""Stage-1 feature extractors (counterparts of ``src/feature_extractors/``)."""
