"""PyTorch/CUDA port of cosyvoice_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (models/, nn/, ops/, runtime/, utils/) so
each module's counterpart is found by name. It imports torch, numpy and the
standard library only. Entry points run on the card (`device="cuda"`) unless
the caller passes `device="cpu"`, and raise when no card is present.
"""
