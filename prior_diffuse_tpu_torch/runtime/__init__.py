"""Native data-plane runtime: WAV decode, crop and RMS-normalise a paired
batch in C++ (``native.py``, ``wav_runtime.cpp``)."""
