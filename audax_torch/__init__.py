"""audax_torch -- the PyTorch/CUDA port of audax for one NVIDIA H100.

It mirrors the JAX package's layout (``core``, ``ops``, ``frontend``,
``models``, ``symbolic``, ``infer``) and imports nothing of it. This slice
carries the Whisper transcription path: wav -> log-mel -> encoder ->
KV-cached greedy decode -> transcript, with the three TPU kernels of that
path rewritten as CUDA C++ for Hopper (``csrc/``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""
