"""Host data pipeline: WAV I/O, paired datasets and loaders, synthetic corpora."""
