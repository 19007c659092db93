"""The hermetic quality recipe: corpus, template ASR, run, diag (see run.py)."""
