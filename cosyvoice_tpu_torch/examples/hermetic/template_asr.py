"""Template ASR of the hermetic recipe: the nearest mel template per word slot.

Counterpart of examples/hermetic/template_asr.py. The corpus words are
harmonic tones with distinct pitch and formant, so a synthesized utterance
is transcribed by cutting its mel spectrogram (ops/mel.mel_spectrogram)
into 0.24 s word slots and matching each slot, by cosine, against the
per-(speaker, word) templates that corpus.make_corpus wrote. It plays the
ASR's role in tools/eval_quality (CER) without an ASR model:

    python -m cosyvoice_tpu_torch.tools.eval_quality ... \\
        --asr cosyvoice_tpu_torch.examples.hermetic.template_asr:transcribe

with HERMETIC_DIR naming the corpus dir (templates.npz); `transcribe(wav,
sr, corpus_dir)` takes the dir as an argument instead.
"""

import os

import numpy as np
import torch

_CACHE = {}


def _templates(corpus_dir: str):
    if corpus_dir not in _CACHE:
        z = np.load(os.path.join(corpus_dir, "templates.npz"))
        t = z["templates"]  # [K, F, 80]
        flat = t.reshape(t.shape[0], -1)
        _CACHE[corpus_dir] = (flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-9), z["units"],
                              int(z["unit_frames"]))
    return _CACHE[corpus_dir]


def transcribe(wav: np.ndarray, sr: int, corpus_dir: str = "") -> str:
    """The words of `wav` ([L] or [1, L] at `sr`), one per slot of
    unit_frames mel frames (the ragged tail padded with the slot's floor),
    joined by spaces and ended with "."."""
    from cosyvoice_tpu_torch.examples.hermetic.corpus import UNITS
    from cosyvoice_tpu_torch.ops.mel import mel_spectrogram

    temps, units, F = _templates(corpus_dir or os.environ["HERMETIC_DIR"])
    x = torch.from_numpy(np.asarray(wav, np.float32).reshape(1, -1))
    mel = mel_spectrogram(x, sr=sr)[0].numpy().T  # [T, 80]
    n_slots = max(1, int(round(mel.shape[0] / F)))
    words = []
    for s in range(n_slots):
        sl = mel[s * F : (s + 1) * F]
        if sl.shape[0] < F:
            sl = np.pad(sl, ((0, F - sl.shape[0]), (0, 0)), constant_values=sl.min())
        v = sl.reshape(-1)
        v = v / (np.linalg.norm(v) + 1e-9)
        words.append(UNITS[int(units[int(np.argmax(temps @ v))])])
    return " ".join(words) + "."
