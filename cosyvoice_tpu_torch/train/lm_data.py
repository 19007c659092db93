"""LM training collation: the unified uni/bi-stream layout, and DPO.

Counterpart of cosyvoice_tpu/train/lm_data.py (the host-side re-derivation
of the reference's Qwen2LM.prepare_lm_input_target): with probability 0.5,
when the sample has enough speech per text token, a sequence is laid out in
bistream order (5 text / 15 speech blocks, a fill-token target at each
block's end); otherwise unistream [sos][instruct?][text][task][speech][eos].
The coin is one `rng.random()` of a `random.Random` per sample, as in the
JAX package, so both draw the same layouts from the same seed.

Sequences are (ids, types) pairs for Qwen2LMModule.embed_input.
"""

import random
from typing import Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from cosyvoice_tpu_torch.models.llm import LMConfig, TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT
from cosyvoice_tpu_torch.train.losses import IGNORE_ID


def build_lm_sample(
    cfg: LMConfig,
    text: np.ndarray,
    speech: np.ndarray,
    instruct: Optional[np.ndarray] = None,
    rng: Optional[random.Random] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (ids, types, targets) int32 arrays of one sample."""
    rng = rng or random
    mt, ms = cfg.mix_ratio
    instruct = instruct if instruct is not None else np.zeros(0, np.int64)
    ids, types, targets = [cfg.sos_id], [TYPE_SPECIAL], [IGNORE_ID]

    def add(tokens, kind, tgts):
        ids.extend(int(x) for x in tokens)
        types.extend([kind] * len(tokens))
        targets.extend(tgts)

    add(instruct, TYPE_TEXT, [IGNORE_ID] * len(instruct))
    bistream = len(text) > 0 and len(speech) / len(text) > ms / mt and rng.random() < 0.5
    if bistream:
        for j in range(int(np.ceil((len(text) + 1) / mt))):
            tb, sb = text[j * mt : (j + 1) * mt], speech[j * ms : (j + 1) * ms]
            if len(tb) == mt:
                add(tb, TYPE_TEXT, [IGNORE_ID] * (mt - 1))
                add(sb, TYPE_SPEECH, [int(x) for x in sb] + [cfg.fill_token])
            else:
                add(tb, TYPE_TEXT, [IGNORE_ID] * len(tb))
                rest = speech[j * ms :]
                add([cfg.task_id], TYPE_SPECIAL, [])
                add(rest, TYPE_SPEECH, [int(x) for x in rest] + [cfg.eos_token])
                break
    else:
        add(text, TYPE_TEXT, [IGNORE_ID] * len(text))
        add([cfg.task_id], TYPE_SPECIAL, [])
        add(speech, TYPE_SPEECH, [int(x) for x in speech] + [cfg.eos_token])
    assert len(ids) == len(targets) == len(types)
    return np.asarray(ids, np.int32), np.asarray(types, np.int32), np.asarray(targets, np.int32)


def collate_lm_batch(cfg: LMConfig, batch: dict, rng: Optional[random.Random] = None, pad_to: int = 8):
    """Padded numpy (ids, types, targets, lengths) of a processor batch: T
    rounded up to a multiple of `pad_to`, pad positions SPEECH id 0 with
    IGNORE_ID targets."""
    samples = []
    B = batch["text_token"].shape[0]
    for i in range(B):
        text = batch["text_token"][i, : batch["text_token_len"][i]]
        speech = batch["speech_token"][i, : batch["speech_token_len"][i]]
        instruct = None
        if "instruct_token" in batch:
            instruct = batch["instruct_token"][i, : batch["instruct_token_len"][i]]
        samples.append(build_lm_sample(cfg, text, speech, instruct, rng))
    T = max(len(s[0]) for s in samples)
    T = ((T + pad_to - 1) // pad_to) * pad_to
    ids = np.zeros((B, T), np.int32)
    types = np.full((B, T), TYPE_SPEECH, np.int32)
    targets = np.full((B, T), IGNORE_ID, np.int32)
    lengths = np.zeros(B, np.int32)
    for i, (s_ids, s_types, s_tgt) in enumerate(samples):
        n = len(s_ids)
        ids[i, :n], types[i, :n], targets[i, :n], lengths[i] = s_ids, s_types, s_tgt, n
    return {"ids": ids, "types": types, "targets": targets, "lengths": lengths}


def dpo_loss(chosen_logps, rejected_logps, ref_chosen_logps, ref_rejected_logps, beta: float = 0.1):
    """The DPO sigmoid loss over per-sequence mean log-probs."""
    ratio = (chosen_logps - rejected_logps) - (ref_chosen_logps - ref_rejected_logps)
    return -torch.log(torch.clamp(1.0 / (1.0 + torch.exp(-beta * ratio)), min=1e-8)).mean()


def sequence_logps(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sequence mean log-prob of the target tokens: logits [B, T, V],
    targets [B, T] with IGNORE_ID padding -> [B]."""
    valid = targets != IGNORE_ID
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    tok_lp = torch.gather(F.log_softmax(logits.float(), dim=-1), -1, tgt[..., None])[..., 0]
    return torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(-1) / valid.sum(-1).clamp_min(1)
