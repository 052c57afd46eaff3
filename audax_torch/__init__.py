"""audax_torch -- the PyTorch/CUDA port of audax for one NVIDIA H100.

It mirrors the JAX package's layout (``core``, ``ops``, ``frontend``,
``models``, ``symbolic``, ``infer``, ``train``, ``cli``) and imports
nothing of it. It carries Whisper transcription (wav -> log-mel -> encoder
-> KV-cached greedy decode -> transcript), Whisper fine-tuning (full and
LoRA), and quantized continuous-batching serving over HTTP (int8/int4
weights, int8 KV), with the TPU kernels of those paths rewritten as CUDA
C++ for Hopper (``csrc/``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""
